"""Data-parallel batch slicing (the part of ``list_tpu/parallel/mesh.py``
the port needs).

The JAX package's ``data`` mesh axis is the process group here: every rank
receives the same global batch and keeps its contiguous rows, rank r the
rows ``[r * B / W, (r + 1) * B / W)``, as ``batch_sharding`` lays the
leading axis over the ``data`` axis.  Where ``auto_mesh`` shrinks the mesh
until it divides the batch, the world size is fixed, so a batch it does
not divide raises.  The ``query`` axis is the dense decode's split over
local devices (``LISTExecutor.predict_grid`` under ``--mesh_shape``).
"""

from __future__ import annotations

from typing import Dict, Optional

from list_tpu_torch.parallel.multihost import process_info


def rank_rows(batch_size: int, rank: Optional[int] = None,
              world: Optional[int] = None) -> slice:
    """This rank's contiguous rows of a global batch of ``batch_size``."""
    r, w = process_info()
    rank = r if rank is None else rank
    world = w if world is None else world
    if batch_size % world:
        raise ValueError(f'global batch {batch_size} does not divide over '
                         f'{world} ranks')
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict, rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """This rank's rows of every array of a global host batch dict."""
    rows = rank_rows(len(next(iter(batch.values()))), rank, world)
    return {k: v[rows] for k, v in batch.items()}


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
