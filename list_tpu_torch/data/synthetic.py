"""Synthetic micro-dataset: procedurally generated shapes with analytic SDFs
(counterpart of ``list_tpu/data/synthetic.py``, copied verbatim apart from
imports).

``SyntheticSDFDataset`` is an in-memory dataset with the IM2SDF batch
interface ('rgb_image', 'points', 'values', 'occ', 'pc'), for train smoke
runs without ShapeNet on disk.  ``quantize_occupancy`` is the JAX
package's ``list_tpu/data/shapenet.py`` function.  The on-disk ShapeNet
tree writer is not copied (it needs h5py and PIL).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

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
