#!/usr/bin/env python3
"""Offline batch mesh evaluation CLI of the PyTorch port (see
list_tpu_torch/eval/offline.py):

    python evaluation/evaluate_torch.py --gen_dir <results>/test_<epoch> \
        --mesh_dir <mesh tree> [--workers N]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from list_tpu_torch.eval.offline import evaluate_main  # noqa: E402

if __name__ == '__main__':
    evaluate_main()
