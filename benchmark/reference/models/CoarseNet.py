"""CoarseNet (stage 1): the reference of a ``"model": "CoarseNet"``
configuration, training only: ``reference/model.py``'s losses,
``reference/weights.py``'s leaves, ``traffic_gen.py``'s batches and
``counts.py``'s FLOPs."""

from benchmark import counts, traffic_gen
from benchmark.reference import model, weights

spec = weights.coarsenet_spec
batches = traffic_gen.coarse_batches
losses = model.coarsenet_losses
train_step_flops = counts.coarsenet_train_step_flops
