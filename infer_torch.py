#!/usr/bin/env python3
"""Test-split sweep of the PyTorch/CUDA port (list_tpu_torch): the port's
counterpart of ``test.py``, with the same flags.

    python infer_torch.py --model network.models.LIST \
        --dataset datasets.Datasets.IM2SDF ... [--device cpu]

Loads ``<output_dir><exp_name>/checkpoints/<test_checkpoint>`` (a JAX
package ``.ckpt`` or the port's torch-format file; else
``best_model_train.ckpt``), sweeps the test split on the card, and writes
``<output_dir><exp_name>/test_<epoch>/<cat>/<shape>/NN_pred.obj`` and, with
``--eval_pred``, the scores CSV.  ``--device cpu`` runs the plain PyTorch
path on the CPU.  ``main(argv)`` returns the CSV's path (None when nothing
was evaluated).
"""

import argparse
import sys

from list_tpu_torch.config import get_args
from list_tpu_torch.infer.pipeline import test_all


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--device', default=None,
                     help="'cuda' (the default) or 'cpu'")
    known, rest = pre.parse_known_args(sys.argv[1:] if argv is None
                                       else argv)
    return test_all(get_args(rest), device=known.device)


if __name__ == '__main__':
    main()
