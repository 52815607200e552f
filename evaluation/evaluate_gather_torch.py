#!/usr/bin/env python3
"""Aggregate per-shape eval pickles into mean/median + CSV (PyTorch port;
see list_tpu_torch/eval/offline.py):

    python evaluation/evaluate_gather_torch.py --eval_dir <gen_dir>/eval
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from list_tpu_torch.eval.offline import gather_main  # noqa: E402

if __name__ == '__main__':
    gather_main()
