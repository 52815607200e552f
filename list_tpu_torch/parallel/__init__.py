"""Multi-process data parallelism (counterpart of ``list_tpu/parallel``):
``multihost`` (the process group) and ``mesh`` (each rank's rows)."""
