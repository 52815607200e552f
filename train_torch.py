#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port (list_tpu_torch): the port's
counterpart of ``train.py``, with the same flags.

  python3 train_torch.py --model network.models.CoarseNet \
      --dataset datasets.Datasets.IM2PointFarthest --color_jitter \
      --normalize ...
  python3 -m list_tpu_torch.train.split_coarse --exp_name coarse_prediciton
  python3 train_torch.py --model network.models.LIST \
      --dataset datasets.Datasets.IM2SDF --sample_distribution 0.45 0.44 0.1 \
      --sdf_scale 10 --warm_start ...

Trains on the card; ``--device cpu`` runs the plain PyTorch path on the
CPU.  With ``--multihost 1`` one command runs per process (README, "N
ranks on N cards"); rank 0 alone snapshots the code and writes the
checkpoints.  Checkpoints are the JAX package's ``.ckpt`` files, under
``<output_dir><exp_name>/checkpoints/``.
"""

import argparse
import os
import sys

from list_tpu_torch.config import get_args
from list_tpu_torch.parallel import multihost
from list_tpu_torch.train.trainer import train
from list_tpu_torch.utils.logging import snapshot_experiment


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--device', default=None,
                     help="'cuda' (the default) or 'cpu'")
    known, rest = pre.parse_known_args(sys.argv[1:] if argv is None
                                       else argv)
    config = get_args(rest)
    # under --multihost 1 the ranks share the experiment directory: join
    # the group first, and rank 0 alone snapshots the code into it
    multihost.maybe_initialize(config, device=known.device)
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    if multihost.process_info()[0] == 0:
        snapshot_experiment(config)
    train(config, device=known.device)


if __name__ == '__main__':
    main()
