"""Offline SDF-sampling preprocessor (reference: preprocessing/preprocess.py),
copied from ``list_tpu/data/preprocess.py`` apart from imports (HDF5 files
through ``utils/h5.py``); ``run_fps`` runs the port's FPS (``ops/fps.py``)
on the card unless the caller asks for the CPU.

Per mesh: normalize into the unit cube centered at the origin
(scale_mesh, preprocess.py:24-43), sample 50,000 surface points
('grid_points'), then for each sigma perturb by sigma*N(0,1) and compute
signed distances -> 'query_points_sigma_<s>' datasets in sampled_points.h5
(gzip).  Signed distance uses the native BVH + parity-sign kernel instead of
igl.signed_distance (same convention: positive outside).

Idempotent: existing sampled_points.h5 are skipped (preprocess.py:85-87).
"""

from __future__ import annotations

import os
import traceback
from glob import glob
from typing import Optional, Sequence

import numpy as np

from list_tpu_torch import native
from list_tpu_torch.utils import h5
from list_tpu_torch.utils.meshio import Mesh, load_mesh


def scale_mesh(input_path: str, out_path: str) -> Optional[Mesh]:
    """Normalize to unit cube centered at origin; cache isosurf_scaled.obj."""
    target = os.path.join(out_path, 'isosurf_scaled.obj')
    if os.path.exists(target):
        return load_mesh(target)
    os.makedirs(out_path, exist_ok=True)
    try:
        mesh = load_mesh(input_path)
        total_size = (mesh.bounds[1] - mesh.bounds[0]).max()
        centers = (mesh.bounds[1] + mesh.bounds[0]) / 2
        mesh.apply_translation(-centers)
        mesh.apply_scale(1.0 / total_size)
        mesh.export(target)
        return mesh
    except Exception:
        print('scale_mesh error with', input_path, traceback.format_exc())
        return None


def sample_boundary_points(mesh: Mesh, points: np.ndarray, sigma: float,
                           rng: np.random.RandomState) -> np.ndarray:
    if sigma == 0:
        boundary = points
        df = np.zeros(len(points))
    else:
        boundary = points + sigma * rng.randn(points.shape[0], 3)
        df = native.signed_distance(boundary, mesh.vertices, mesh.faces)
    return np.concatenate((boundary, df.reshape(-1, 1)), 1)


def run(path: str, output_dir: str, sigma: Sequence[float],
        num_points: int, seed: int = 333) -> None:
    try:
        cat_id, shape_id, _ = path.split('/')[-3:]
        point_path = os.path.join(output_dir, 'sampled_points', cat_id,
                                  shape_id)
        out_file = os.path.join(point_path, 'sampled_points.h5')
        if os.path.exists(out_file):
            print(out_file, 'Exists. Skipping')
            return
        os.makedirs(point_path, exist_ok=True)

        mesh_path = os.path.join(output_dir, 'isosurface', cat_id, shape_id)
        mesh = scale_mesh(path, mesh_path)
        if mesh is None:
            return
        rng = np.random.RandomState(seed)
        point_cloud = mesh.sample(num_points, rng=rng)

        with h5.File(out_file, 'w') as f:
            f.create_dataset('grid_points', data=point_cloud,
                             compression='gzip')
            for s in sigma:
                qdf = sample_boundary_points(mesh, point_cloud, float(s), rng)
                f.create_dataset(f'query_points_sigma_{s}', data=qdf,
                                 compression='gzip')
    except Exception:
        print('Problem with', path)
        print('Exception', traceback.format_exc())


def run_fps(h5_dir: str, k: int = 5000, use_device: bool = True,
            device=None) -> int:
    """FPS preprocessing (reference: preprocessing/farthest_pointcloud.py):
    for every sampled_points.h5, write farthest_pointclouds.h5['points_<k>']
    with a K-point farthest subset of grid_points.  Runs the port's FPS on
    ``device`` (the card unless the caller passes ``device='cpu'``) instead
    of the pytorch3d CUDA op.  ``use_device`` is accepted and unused, as in
    the JAX package.  Returns #processed."""
    import torch

    from list_tpu_torch.device import resolve_device
    from list_tpu_torch.ops.fps import farthest_point_sampling

    dev = resolve_device(device)
    n_done = 0
    for h5_fn in sorted(glob(os.path.join(h5_dir, '*', '*',
                                          'sampled_points.h5'))):
        out_fn = os.path.join(os.path.dirname(h5_fn),
                              'farthest_pointclouds.h5')
        if os.path.exists(out_fn):
            continue
        with h5.File(h5_fn, 'r') as f:
            pts = f['grid_points'][:]
        idx = farthest_point_sampling(
            torch.as_tensor(pts, dtype=torch.float32, device=dev),
            min(k, len(pts))).cpu().numpy()
        with h5.File(out_fn, 'w') as f:
            f.create_dataset(f'points_{k}', data=pts[idx],
                             compression='gzip')
        n_done += 1
    return n_done


def main(argv=None):
    import argparse
    import multiprocessing as mp
    from functools import partial

    parser = argparse.ArgumentParser(description='Run point cloud sampling')
    parser.add_argument('--input_dir', type=str,
                        default='./Datasets/shapenet/DISN/')
    parser.add_argument('--output_dir', type=str,
                        default='./Datasets/shapenet/')
    parser.add_argument('--num_points', type=int, default=50000)
    parser.add_argument('--sigma', nargs='+', type=float,
                        default=[0.003, 0.01, 0.07])
    parser.add_argument('--categories', nargs='+')
    parser.add_argument('--file_path_glob', type=str,
                        help='/<instance>*/*filename.ext pattern')
    parser.add_argument('--workers', type=int, default=mp.cpu_count())
    args = parser.parse_args(argv)

    files = []
    for c in args.categories or []:
        files.extend(glob(args.input_dir + c + args.file_path_glob))
    print(args.categories, len(files))

    fn = partial(run, output_dir=args.output_dir, sigma=args.sigma,
                 num_points=args.num_points)
    if args.workers <= 1:
        for f in files:
            fn(f)
    else:
        with mp.Pool(args.workers) as p:
            for _ in p.imap_unordered(fn, files):
                pass


if __name__ == '__main__':
    main()
