#!/usr/bin/env python3
"""Offline FPS CLI of the PyTorch port: farthest-point sampling on the card
(replaces the reference's pytorch3d CUDA op,
preprocessing/farthest_pointcloud.py; see list_tpu_torch/ops/fps.py):

    python preprocessing/farthest_pointcloud_torch.py --h5_dir <tree>/ \
        [--k 5000] [--device cpu]

Writes farthest_pointclouds.h5['points_<k>'] beside every
<h5_dir>/<cat>/<shape>/sampled_points.h5 that has none yet.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from list_tpu_torch.data.preprocess import run_fps  # noqa: E402

if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--h5_dir', default='./Datasets/shapenet/sampled_points/')
    p.add_argument('--k', type=int, default=5000)
    p.add_argument('--device', default=None,
                   help="torch device (default: cuda; 'cpu' for the plain "
                        'path)')
    args = p.parse_args()
    n = run_fps(args.h5_dir, args.k, device=args.device)
    print(f'FPS: processed {n} shapes')
