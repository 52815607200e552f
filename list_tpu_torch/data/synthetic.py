"""Synthetic micro-dataset: procedurally generated shapes with analytic SDFs
(counterpart of ``list_tpu/data/synthetic.py``, copied verbatim apart from
imports).

``SyntheticSDFDataset`` is an in-memory dataset with the IM2SDF batch
interface ('rgb_image', 'points', 'values', 'occ', 'pc'), for train smoke
runs without ShapeNet on disk; ``generate_synthetic_shapenet`` writes a
miniature ShapeNet-format tree for the on-disk readers and the drivers
(PIL imported there; HDF5 files through ``utils/h5.py``).
``quantize_occupancy`` is the JAX package's ``list_tpu/data/shapenet.py``
function.  ``generate_synthetic_pix3d`` (the port's own) writes a raw
Pix3D-format tree for the preprocessing and the Pix3D reader.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from list_tpu_torch.utils import h5
from list_tpu_torch.utils.meshio import Mesh


def quantize_occupancy(points: np.ndarray, bb_min: float, bb_max: float,
                       res: int) -> np.ndarray:
    """Host-side equivalent of the cKDTree voxelization (Datasets.py:286-291):
    exact nearest-grid-point quantization; returns flat uint8 (res^3,)."""
    step = (bb_max - bb_min) / (res - 1)
    idx = np.clip(np.round((points - bb_min) / step), 0, res - 1).astype(np.int64)
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    occ = np.zeros(res ** 3, np.uint8)
    occ[flat] = 1
    return occ


def sphere_sdf(p: np.ndarray, center, radius: float) -> np.ndarray:
    return np.linalg.norm(p - np.asarray(center), axis=-1) - radius


def box_sdf(p: np.ndarray, center, half_extents) -> np.ndarray:
    q = np.abs(p - np.asarray(center)) - np.asarray(half_extents)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(q.max(-1), 0.0)
    return outside + inside


class SyntheticShape:
    """A random union of primitives inside [-0.4, 0.4]^3."""

    def __init__(self, rng: np.random.RandomState):
        self.prims = []
        n = rng.randint(1, 3)
        for _ in range(n):
            kind = rng.choice(['sphere', 'box'])
            center = rng.uniform(-0.15, 0.15, 3)
            if kind == 'sphere':
                self.prims.append(('sphere', center,
                                   rng.uniform(0.12, 0.3)))
            else:
                self.prims.append(('box', center,
                                   rng.uniform(0.1, 0.25, 3)))

    def sdf(self, p: np.ndarray) -> np.ndarray:
        vals = []
        for kind, center, param in self.prims:
            if kind == 'sphere':
                vals.append(sphere_sdf(p, center, param))
            else:
                vals.append(box_sdf(p, center, param))
        return np.min(np.stack(vals), axis=0)

    def mesh(self, res: int = 64) -> Mesh:
        from list_tpu_torch.utils.meshing import generate_mesh
        x = np.linspace(-0.5, 0.5, res)
        X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
        grid = self.sdf(np.stack([X, Y, Z], -1).reshape(-1, 3)).reshape(
            res, res, res)
        return generate_mesh(grid, -0.5, 0.5, as_trimesh_obj=True,
                             renorm='exact')

    def render(self, img_res: int = 224, view_angle: float = 0.0
               ) -> np.ndarray:
        """Crude orthographic SDF-raymarch render with lambertian shading —
        enough visual signal for the encoder to correlate shape and image."""
        u = np.linspace(-0.6, 0.6, img_res)
        px, py = np.meshgrid(u, -np.asarray(u), indexing='xy')
        c, s = np.cos(view_angle), np.sin(view_angle)
        # camera looks along rotated -z
        depth = np.full(px.shape, np.inf)
        t = np.full(px.shape, -0.7)
        for _ in range(48):
            wx = c * px + s * t
            wy = py
            wz = -s * px + c * t
            d = self.sdf(np.stack([wx, wy, wz], -1).reshape(-1, 3)).reshape(
                px.shape)
            hit = d < 1e-3
            depth = np.where(hit & (depth == np.inf), t, depth)
            t = t + np.clip(d, 1e-3, 0.1) * (depth == np.inf)
        mask = depth != np.inf
        # normal from depth gradient for cheap shading
        shade = np.zeros_like(px)
        if mask.any():
            zb = np.where(mask, depth, depth[mask].max())
            gy, gx = np.gradient(zb)
            nz = 1.0 / np.sqrt(1.0 + gx ** 2 + gy ** 2)
            shade = np.where(mask, 0.35 + 0.65 * nz, 1.0)
        img = np.stack([shade, shade, shade], -1).astype(np.float32)
        return np.clip(img, 0.0, 1.0)


class SyntheticSDFDataset:
    """IM2SDF-compatible dataset backed by procedural shapes (no disk)."""

    def __init__(self, config, status: str, n_shapes: int = 8):
        self.config = config
        self.status = status
        self.img_res = config.img_res
        self.vox_res = config.vox_res
        self.query_samples = np.rint(np.asarray(config.sample_distribution)
                                     * config.sample_point_density
                                     ).astype(np.uint32)
        self.sigmas = config.sigmas
        seed = 333 if status == 'train' else 444
        self.rng = np.random.RandomState(seed)
        self._gen = np.random.default_rng(seed)
        self.shapes: List[SyntheticShape] = [
            SyntheticShape(self.rng) for _ in range(n_shapes)]
        self._images = [s.render(self.img_res) for s in self.shapes]
        self.datalist = [{'cat_id': 'synthetic', 'shape_id': str(i),
                          'img_id': '00.png'}
                         for i in range(n_shapes)]
        self.coarse_points = config.coarse_point_density

    def __len__(self):
        return len(self.shapes)

    def _surface_points(self, shape: SyntheticShape, n: int) -> np.ndarray:
        return shape.mesh(48).sample(n, rng=self.rng)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        shape = self.shapes[index]
        surface = self._surface_points(shape, 5000)
        total = int(self.query_samples.sum())
        pts = []
        for num, sigma in zip(self.query_samples, self.sigmas):
            base = surface[self._gen.integers(0, len(surface), int(num))]
            pts.append(base + sigma * self._gen.standard_normal((int(num), 3)))
        points = np.concatenate(pts, 0).astype(np.float32)
        values = shape.sdf(points).astype(np.float32)
        occ = quantize_occupancy(surface, self.config.bb_min,
                                 self.config.bb_max, self.vox_res)
        return {'rgb_image': self._images[index],
                'points': points, 'values': values,
                'occ': occ.reshape((self.vox_res,) * 3).astype(np.float32),
                'pc': surface.astype(np.float32)}

    def get_testdata(self, cat_id, shape_id, cam_id) -> Dict:
        idx = int(shape_id)
        return {'rgb_image': self._images[idx][None],
                'gt_mesh': self.shapes[idx].mesh(64),
                'cat_id': cat_id, 'shape_id': shape_id}


def generate_synthetic_shapenet(root: str, cats=('03001627',),
                                n_shapes: int = 2, n_views: int = 2,
                                img_res: int = 224, n_surface: int = 2000,
                                sigmas=(0.003, 0.01, 0.07),
                                seed: int = 333) -> Dict[str, List[str]]:
    """Write a miniature ShapeNet-format tree usable by IM2SDF /
    IM2PointFarthest / the train and test drivers.  Returns {cat: [ids]}."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    out = {}
    for cat in cats:
        ids = []
        for i in range(n_shapes):
            shape = SyntheticShape(rng)
            sid = f'synth{i:04d}'
            ids.append(sid)
            img_dir = os.path.join(root, 'images', cat, sid, 'easy')
            h5_dir = os.path.join(root, 'sampled_points', cat, sid)
            mesh_dir = os.path.join(root, 'mesh', cat, sid)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(h5_dir, exist_ok=True)
            os.makedirs(mesh_dir, exist_ok=True)

            for v in range(n_views):
                img = shape.render(img_res, view_angle=v * np.pi / 6)
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    os.path.join(img_dir, f'{v:02d}.png'))

            mesh = shape.mesh(48)
            mesh.export(os.path.join(mesh_dir, 'isosurf_scaled.obj'))

            surface = mesh.sample(n_surface, rng=rng)
            with h5.File(os.path.join(h5_dir, 'sampled_points.h5'),
                           'w') as f:
                f.create_dataset('grid_points', data=surface)
                for s in sigmas:
                    q = surface + s * rng.randn(len(surface), 3)
                    sdf = shape.sdf(q)
                    f.create_dataset(f'query_points_sigma_{s}',
                                     data=np.concatenate(
                                         [q, sdf[:, None]], 1))
            with h5.File(os.path.join(h5_dir, 'farthest_pointclouds.h5'),
                           'w') as f:
                f.create_dataset('points_5000', data=surface[
                    rng.choice(len(surface), 5000)])
        out[cat] = ids

    split_dir = os.path.join(root, 'split')
    os.makedirs(split_dir, exist_ok=True)
    for cat, ids in out.items():
        for status in ('train', 'test'):
            with open(os.path.join(split_dir, f'{cat}_{status}.lst'),
                      'w') as f:
                f.write('\n'.join(ids) + '\n')
    with open(os.path.join(split_dir, 'testlist_all.lst'), 'w') as f:
        for cat, ids in out.items():
            for sid in ids:
                f.write(f'{cat} {sid} 00\n')
    return out


def generate_synthetic_pix3d(root: str, cat: str = 'chair',
                             n_shapes: int = 8, n_test: int = 4,
                             img_res: int = 224, mesh_res: int = 64,
                             seed: int = 333) -> List[str]:
    """Write a raw Pix3D-format tree of synthetic shapes, one image each,
    for ``data/preprocess.py`` and then the Pix3D reader (layout:
    ``data/pix3d.py``):

    - ``meshes/<cat>/model<i>.model/model.obj``: the raw mesh (scaled by
      1.7 and moved off the origin), where the preprocessor's
      ``<cat>/<folder>/<file>`` path gives the reader's model folder (the
      model path's last two parts joined by '.');
    - ``data/isosurface/<cat>/model<i>.model/mesh_org.ply``: the same mesh,
      which the reader requires beside the preprocessor's
      ``isosurf_scaled.obj``;
    - ``data/img/<cat>/model<i>.model/<i:04d>.npy``: one uint8 render;
    - ``data/pix3d.json`` and ``splits/{train,test}.json``: every image in
      the train split, the first ``n_test`` in the test split.

    Returns the raw meshes' paths, the preprocessor's inputs."""
    from list_tpu_torch.utils.meshio import write_ply

    rng = np.random.RandomState(seed)
    data = os.path.join(root, 'data')
    metadatas, names, paths = [], [], []
    for i in range(n_shapes):
        shape = SyntheticShape(rng)
        mesh = shape.mesh(mesh_res).apply_scale(1.7).apply_translation(
            rng.uniform(-0.5, 0.5, 3))
        folder, img_name = f'model{i:03d}.model', f'{i:04d}'
        dirs = [os.path.join(root, 'meshes', cat, folder)] + [
            os.path.join(data, sub, cat, folder)
            for sub in ('isosurface', 'img')]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        paths.append(os.path.join(dirs[0], 'model.obj'))
        mesh.export(paths[-1])
        write_ply(os.path.join(dirs[1], 'mesh_org.ply'), mesh.vertices,
                  mesh.faces)
        np.save(os.path.join(dirs[2], img_name + '.npy'),
                (shape.render(img_res) * 255).astype(np.uint8))
        metadatas.append({'category': cat,
                          'img': f'img/{cat}/{img_name}.png',
                          'model': f'model/{cat}/model{i:03d}/model.obj'})
        names.append(f'img/{img_name}.png')
    with open(os.path.join(data, 'pix3d.json'), 'w') as f:
        json.dump(metadatas, f)
    os.makedirs(os.path.join(root, 'splits'), exist_ok=True)
    for mode, split in (('train', names), ('test', names[:n_test])):
        with open(os.path.join(root, 'splits', mode + '.json'), 'w') as f:
            json.dump(split, f)
    return paths
