"""Inputs of every cell, made from the run's seed.

The shapes are the port's synthetic data set (``SyntheticShape`` and
``quantize_occupancy`` of ``list_tpu_torch/data/synthetic.py``), copied
here and batched in torch so that a run makes them on the device in bulk:
a union of one or two primitives (spheres of radius 0.12-0.3, boxes of
half extent 0.1-0.25, centres within 0.15 of the origin) with an analytic
SDF, rendered 224^2 by the same orthographic ray march and shading.
Surface points are drawn on the primitives' surfaces, area-weighted, and
kept where they lie on the union's surface (the original sampled a
marching-cubes mesh of the SDF).

- ``list_batches``: stage-2 batches as the IM2SDF reader gives them (host
  arrays): images; per sample rint(distribution x density) queries around
  5,000 surface points at the configuration's sigmas, with their SDF; the
  occupancy of ``occupancy_points`` surface points on the voxel grid.
- ``coarse_batches``: images and ``gt_points`` surface points (stage 1).
- ``images``: distinct renders for the mesh requests, and
  ``fit_targets``: points around and between the first of those shapes
  with their SDF, to which the mesh cells fit the decoder's output layer.

Shape parameters come from a numpy generator and the bulk from a
``torch.Generator`` on the device, both seeded from the run's seed.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.weights import stream_seed

SURFACE = 5000


class Shapes:
    """S random shapes of up to two primitives, as tensors on ``device``."""

    def __init__(self, rng: np.random.Generator, n: int, device):
        kind = np.zeros((n, 2), np.int64)     # 0 sphere, 1 box
        center = np.zeros((n, 2, 3))
        size = np.ones((n, 2, 3))
        active = np.zeros((n, 2), bool)
        for s in range(n):
            for j in range(rng.integers(1, 3)):
                active[s, j] = True
                kind[s, j] = rng.integers(0, 2)
                center[s, j] = rng.uniform(-0.15, 0.15, 3)
                size[s, j] = (rng.uniform(0.12, 0.3) if kind[s, j] == 0
                              else rng.uniform(0.1, 0.25, 3))
        t = dict(device=device, dtype=torch.float32)
        self.n = n
        self.kind = torch.as_tensor(kind, device=device)
        self.center = torch.as_tensor(center, **t)
        self.size = torch.as_tensor(size, **t)
        self.active = torch.as_tensor(active, device=device)

    def first(self, n: int) -> 'Shapes':
        sub = copy.copy(self)
        sub.n = n
        for k in ('kind', 'center', 'size', 'active'):
            setattr(sub, k, getattr(self, k)[:n])
        return sub

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        """p (S, ..., 3) -> (S, ...): the union's signed distance."""
        shape = p.shape
        p = p.reshape(self.n, -1, 1, 3) - self.center[:, None]
        sph = p.norm(dim=-1) - self.size[:, None, :, 0]
        q = p.abs() - self.size[:, None]
        box = q.clamp_min(0).norm(dim=-1) + q.amax(-1).clamp_max(0)
        d = torch.where(self.kind[:, None] == 0, sph, box)
        d = torch.where(self.active[:, None], d, torch.full_like(d, 1e9))
        return d.amin(-1).reshape(shape[:-1])

    def render(self, img_res: int) -> torch.Tensor:
        """(S, img_res, img_res, 3) orthographic ray-march renders with
        Lambertian shading from the depth gradient, in [0, 1]."""
        dev = self.center.device
        u = torch.linspace(-0.6, 0.6, img_res, device=dev)
        py, px = torch.meshgrid(-u, u, indexing='ij')
        px = px.expand(self.n, -1, -1)
        py = py.expand(self.n, -1, -1)
        depth = torch.full_like(px, float('inf'))
        t = torch.full_like(px, -0.7)
        for _ in range(48):
            d = self.sdf(torch.stack([px, py, t], -1))
            hit = d < 1e-3
            depth = torch.where(hit & torch.isinf(depth), t, depth)
            t = t + d.clamp(1e-3, 0.1) * torch.isinf(depth)
        mask = ~torch.isinf(depth)
        far = torch.where(mask, depth, torch.full_like(depth, -1e9)).amax(
            dim=(1, 2), keepdim=True)
        zb = torch.where(mask, depth, far)
        gy, gx = torch.gradient(zb, dim=(1, 2))
        nz = torch.rsqrt(1.0 + gx ** 2 + gy ** 2)
        shade = torch.where(mask, 0.35 + 0.65 * nz, torch.ones_like(nz))
        return shade[..., None].expand(-1, -1, -1, 3).clamp(0, 1)

    def surface(self, n: int, g: torch.Generator) -> torch.Tensor:
        """(S, n, 3) points on the union's surface, area-weighted."""
        dev, S, m = self.center.device, self.n, 3 * n
        h = self.size
        sph_area = 4 * torch.pi * h[..., 0] ** 2
        faces = torch.stack([h[..., 1] * h[..., 2], h[..., 0] * h[..., 2],
                             h[..., 0] * h[..., 1]], -1)   # per axis
        box_area = 8 * faces.sum(-1)
        area = torch.where(self.kind == 0, sph_area, box_area) * self.active
        prim = torch.multinomial(area, m, replacement=True, generator=g)
        take = lambda t: torch.gather(  # noqa: E731
            t, 1, prim.view(S, m, *([1] * (t.dim() - 2))).expand(
                -1, -1, *t.shape[2:]))
        c, hs, kind = take(self.center), take(h), take(self.kind)
        dirs = torch.randn(S, m, 3, generator=g, device=dev)
        sph = c + hs[..., :1] * dirs / dirs.norm(dim=-1, keepdim=True)
        cum = take(faces).cumsum(-1)
        u = torch.rand(S, m, 1, generator=g, device=dev) * cum[..., 2:]
        axis = (u > cum[..., :1]).long()[..., 0] + (u > cum[..., 1:2]).long(
        )[..., 0]
        uv = torch.rand(S, m, 3, generator=g, device=dev) * 2 - 1
        sign = torch.where(torch.rand(S, m, generator=g, device=dev) < 0.5,
                           -1.0, 1.0)
        onface = torch.nn.functional.one_hot(axis, 3).bool()
        box = c + hs * torch.where(onface, sign[..., None], uv)
        pts = torch.where((kind == 0)[..., None], sph, box)
        keep = self.sdf(pts) > -1e-5
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        count = keep.sum(1, keepdim=True).clamp_min(1)
        # a shape short of kept points repeats them
        idx = torch.gather(order, 1, torch.arange(n, device=dev)[None]
                           % count)
        return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))


def occupancy(points: torch.Tensor, bb_min: float, bb_max: float,
              res: int) -> torch.Tensor:
    """(S, N, 3) -> (S, res, res, res) float32: 1 at each point's nearest
    grid point (``quantize_occupancy``)."""
    step = (bb_max - bb_min) / (res - 1)
    idx = torch.round((points - bb_min) / step).clamp(0, res - 1).long()
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    occ = torch.zeros(points.shape[0], res ** 3, device=points.device)
    occ.scatter_(1, flat, 1.0)
    return occ.view(-1, res, res, res)


def _gens(seed: int, what: str, device):
    rng = np.random.default_rng(stream_seed(seed, f'{what}:shapes'))
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, f'{what}:bulk'))
    return rng, g


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def queries(cfg: Dict, surf: torch.Tensor, g: torch.Generator
            ) -> torch.Tensor:
    """(S, n, 3) surface points -> (S, Q, 3) training queries: per shape
    rint(distribution x density) around the points at each sigma."""
    pts = []
    for frac, sigma in zip(cfg['sample_distribution'], cfg['sigmas']):
        k = int(round(frac * cfg['sample_point_density']))
        pick = torch.randint(0, surf.shape[1], (surf.shape[0], k),
                             generator=g, device=surf.device)
        base = torch.gather(surf, 1, pick[..., None].expand(-1, -1, 3))
        pts.append(base + sigma * torch.randn(surf.shape[0], k, 3,
                                              generator=g,
                                              device=surf.device))
    return torch.cat(pts, 1)


def list_batches(cfg: Dict, traffic: Dict, seed: int, device
                 ) -> List[Dict[str, np.ndarray]]:
    B, nb = cfg['train_batch_size'], traffic['distinct_batches']
    rng, g = _gens(seed, 'list_batches', device)
    shapes = Shapes(rng, B * nb, device)
    img = shapes.render(cfg['img_res'])
    surf = shapes.surface(SURFACE, g)
    occ = occupancy(shapes.surface(cfg['occupancy_points'], g),
                    cfg['bb_min'], cfg['bb_max'], cfg['vox_res'])
    pts = queries(cfg, surf, g)
    vals = shapes.sdf(pts)
    return [{'rgb_image': _host(img[i * B:(i + 1) * B]),
             'points': _host(pts[i * B:(i + 1) * B]),
             'values': _host(vals[i * B:(i + 1) * B]),
             'occ': _host(occ[i * B:(i + 1) * B])} for i in range(nb)]


def coarse_batches(cfg: Dict, traffic: Dict, seed: int, device
                   ) -> List[Dict[str, np.ndarray]]:
    B, nb = cfg['train_batch_size'], traffic['distinct_batches']
    rng, g = _gens(seed, 'coarse_batches', device)
    shapes = Shapes(rng, B * nb, device)
    img = shapes.render(cfg['img_res'])
    pc = shapes.surface(cfg['gt_points'], g)
    return [{'rgb_image': _host(img[i * B:(i + 1) * B]),
             'pc': _host(pc[i * B:(i + 1) * B])} for i in range(nb)]


def images(cfg: Dict, n: int, seed: int, device):
    """(n, H, W, 3) float32 host renders of n distinct shapes, and the
    shapes."""
    rng, _ = _gens(seed, 'images', device)
    shapes = Shapes(rng, n, device)
    return _host(shapes.render(cfg['img_res'])), shapes


def fit_targets(cfg: Dict, shapes: Shapes, n: int, stride: int, seed: int):
    """-> (points (n, Q, 3), their SDF (n, Q)) of the first n shapes, at
    which a decoder is fitted to them: the training queries around their
    surfaces and the voxel grid's points at ``stride``."""
    _, g = _gens(seed, 'fit', shapes.center.device)
    sub = shapes.first(n)
    near = queries(cfg, sub.surface(SURFACE, g), g)
    ax = torch.linspace(cfg['bb_min'], cfg['bb_max'], cfg['vox_res'],
                        device=near.device, dtype=torch.float64)[::stride]
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing='ij'), -1)
    grid = grid.reshape(1, -1, 3).float().expand(n, -1, -1)
    pts = torch.cat([near, grid], 1)
    return pts, sub.sdf(pts)
