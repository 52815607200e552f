"""DISN: the reference of a ``"model": "DISN"`` configuration (Xu, Wang,
Chen, Mech, Neumann, "DISN: Deep Implicit Surface Network for
High-quality Single-view 3D Reconstruction", NeurIPS 2019,
arXiv:1905.10711; github.com/Xharlie/DISN).

Written from the paper and its public code, as functions of a dict of
parameters named as in ``spec``, in plain PyTorch (``torch.nn.functional``
does the convolutions, resizes and samples; nothing of the program):

- the encoder, VGG-16 on the 137^2 image: thirteen 3x3 SAME convolutions
  with ReLU and no BatchNorm in five blocks (2, 2, 3, 3, 3), a 2x2 max
  pooling of stride 2 after each block; the classifier fc6 -> fc7 -> fc8
  (ReLU between, none after fc8), fc8's 1,024 values the global feature;
- the local feature: the maps ``conv1_2`` ... ``conv5_3`` resized to
  137^2 (bilinear, align corners), concatenated (1,472 channels) and
  sampled bilinearly at the query projected through the (4, 3) camera
  with the perspective divide (``reference/model.py`` ``percep``);
- two streams, each a point MLP 3 -> 64 -> 256 -> 512 and a head
  ``[point | feature]`` -> 512 -> 256 -> 1 (ReLU after every layer but
  the last): one on the global feature, one on the local; the SDF is
  their sum;
- the loss: L1 against the target SDF times ``sdf_scale``, weighted m1
  where the unscaled target is below delta and m2 elsewhere, the mean
  over the batch's queries.

Departures from the published description, stated in the configuration
too: the camera is an input (the paper's ground-truth-camera results; its
camera-estimation network is a model of its own), here the synthetic
renders' orthographic view; before fc6 an adaptive average pooling to
7 x 7 (at 137^2, pool5 is 4 x 4, and slim's 7 x 7 VALID fc6 cannot apply;
fc6 keeps its published 25,088 inputs); one point MLP a stream, as the
code builds one in each stream's decoder; no dropout in the classifier
(the comparison needs a deterministic step).

``prepare_mesh`` fits the weights to the traffic as a trained model's
are: the two streams' output layers (256 -> 1 each, one bias) are solved
together by ridge least squares so that the summed SDF gives the first
``fit_images`` images' analytic SDF at points around their surfaces and
at the voxel grid's points at ``FIT_STRIDE``; random weights give no
surface.

``head_bound_s`` is the least time of the dense decode's head (the span
``decode.head``) as the program does the work, read by
``metrics/disn_head_roofline_pct.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import traffic_gen
from benchmark.reference import model, weights

BLOCK_CONVS = (2, 2, 3, 3, 3)
POOL = 7
# the loss's published weights: m1 below delta (unscaled SDF), m2 above
DELTA, M1, M2 = 0.01, 4.0, 1.0
FIT_STRIDE = 4
# the ridge, a share of the Gram matrix's mean diagonal: at 1e-4 (LIST's)
# the output weights cancel (norms 5.7-7.1) and the program's bfloat16
# round-offs move the surface by 0.7 voxels at 48^3 on the CPU; at 1e-2
# (norms 1.3-1.5) by 0.17, the surface no farther from the shapes'
# (PERF.md)
FIT_RIDGE = 1e-2
# queries a fitted shape around its surface, at the configuration's
# sigmas and distribution
FIT_DENSITY = 32768


def _convs(cfg: Dict):
    """(block, name, c_in, c_out) of every convolution."""
    out, c_in = [], 3
    for b, n in enumerate(BLOCK_CONVS):
        for i in range(n):
            c = cfg['vgg_widths'][b]
            out.append((b, f'encoder.conv{b + 1}_{i + 1}', c_in, c))
            c_in = c
    return out


def _fc_dims(cfg: Dict) -> List[int]:
    return [cfg['vgg_widths'][-1] * POOL * POOL] + list(cfg['vgg_fc'])


def _stream_dims(cfg: Dict, feat: int):
    point = [3] + list(cfg['disn_point'])
    head = [point[-1] + feat] + list(cfg['disn_head'])
    return point, head


def _streams(cfg: Dict):
    return (('stream_g', cfg['vgg_fc'][-1]),
            ('stream_l', sum(cfg['vgg_widths'])))


def spec(cfg: Dict) -> List[weights.Leaf]:
    out = []
    for _, name, c_in, c in _convs(cfg):
        out += weights._conv(name, c_in, c, (3, 3), True)
    dims = _fc_dims(cfg)
    for i, (a, o) in enumerate(zip(dims, dims[1:])):
        out += weights._linear(f'encoder.fc{6 + i}', a, o)
    for pre, feat in _streams(cfg):
        point, head = _stream_dims(cfg, feat)
        for i, (a, o) in enumerate(zip(point, point[1:])):
            out += weights._linear(f'{pre}.point{i + 1}', a, o)
        for i, (a, o) in enumerate(zip(head, head[1:])):
            out += weights._linear(f'{pre}.fc{i + 1}', a, o)
        out += weights._linear(f'{pre}.fc_out', head[-1], 1, gain=1.0)
    return out


def encode(P, cfg: Dict, img: torch.Tensor, trans_mat=None) -> Dict:
    """img (B, H, W, 3) -> the global feature, the 137^2 maps (NCHW) and
    the camera (the configuration's where ``trans_mat`` is None)."""
    h, taps, block = img.permute(0, 3, 1, 2), [], 0
    for b, name, _, _ in _convs(cfg):
        if b != block:
            taps.append(h)
            h = F.max_pool2d(h, 2, 2)
            block = b
        h = F.relu(F.conv2d(h, P[f'{name}.weight'], P[f'{name}.bias'],
                            padding=1))
    taps.append(h)
    h = F.adaptive_avg_pool2d(F.max_pool2d(h, 2, 2), POOL).flatten(1)
    n_fc = len(cfg['vgg_fc'])
    for i in range(n_fc):
        h = model._lin(P, f'encoder.fc{6 + i}', h)
        if i < n_fc - 1:
            h = F.relu(h)
    ms = model.PERCEP_MAP
    fmaps = torch.cat([F.interpolate(t, size=(ms, ms), mode='bilinear',
                                     align_corners=True) for t in taps], 1)
    if trans_mat is None:
        trans_mat = torch.tensor(cfg['disn_camera'], dtype=img.dtype,
                                 device=img.device).view(1, 4, 3).expand(
                                     img.shape[0], 4, 3)
    return dict(glob=h, fmaps=fmaps, trans_mat=trans_mat)


def _hidden(P, cfg: Dict, pre: str, q: torch.Tensor, feat: torch.Tensor,
            low: bool) -> torch.Tensor:
    """A stream up to its output layer: (B, N, 3), (B, N, F) -> (B, N,
    H)."""
    x = q
    for i in range(len(cfg['disn_point'])):
        x = F.relu(model._lin(P, f'{pre}.point{i + 1}', x, low))
    x = torch.cat([x, feat], -1)
    for i in range(len(cfg['disn_head'])):
        x = F.relu(model._lin(P, f'{pre}.fc{i + 1}', x, low))
    return x


def features(P, cfg: Dict, q: torch.Tensor, enc: Dict, low: bool = False):
    """Both streams' last hidden layers at the queries q (B, N, 3)."""
    local = model.percep(enc['fmaps'], q, enc['trans_mat'])
    glob = enc['glob'][:, None].expand(-1, q.shape[1], -1)
    return (_hidden(P, cfg, 'stream_g', q, glob, low),
            _hidden(P, cfg, 'stream_l', q, local, low))


def decode(P, cfg: Dict, q: torch.Tensor, enc: Dict, low: bool = False
           ) -> torch.Tensor:
    """q (B, N, 3) world coordinates -> (B, N) raw SDF (``sdf_scale``
    units); ``low``: the fp8 decoder of the control."""
    hg, hl = features(P, cfg, q, enc, low)
    return (model._lin(P, 'stream_g.fc_out', hg, low)
            + model._lin(P, 'stream_l.fc_out', hl, low))[..., 0]


def weighted_l1(pred: torch.Tensor, values: torch.Tensor, cfg: Dict
                ) -> torch.Tensor:
    w = torch.where(values < DELTA, M1, M2)
    return (w * (pred - values * cfg['sdf_scale']).abs()).mean()


def losses(P, cfg: Dict, batch: Dict, chunk: int = 0, low: bool = False
           ) -> Dict[str, torch.Tensor]:
    """One training forward and backward of a device batch; the gradients
    land in ``P``'s leaves (``chunk`` unused: the loss is one mean)."""
    enc = encode(P, cfg, batch['rgb_image'], batch.get('trans_mat'))
    loss = weighted_l1(decode(P, cfg, batch['points'], enc, low),
                       batch['values'], cfg)
    loss.backward()
    return {'sdf_loss': loss.detach()}


def batches(cfg: Dict, traffic: Dict, seed: int, device
            ) -> List[Dict[str, np.ndarray]]:
    """Training batches (host arrays): renders, per sample rint(distribution
    x density) queries around its surface with their SDF, and each
    sample's camera (the configuration's)."""
    B, nb = cfg['train_batch_size'], traffic['distinct_batches']
    rng, g = traffic_gen._gens(seed, 'disn_batches', device)
    shapes = traffic_gen.Shapes(rng, B * nb, device)
    img = shapes.render(cfg['img_res'])
    pts = traffic_gen.queries(cfg, shapes.surface(traffic_gen.SURFACE, g), g)
    vals = shapes.sdf(pts)
    cam = np.broadcast_to(np.asarray(cfg['disn_camera'], np.float32).reshape(
        1, 4, 3), (B, 4, 3)).copy()
    return [{'rgb_image': traffic_gen._host(img[i * B:(i + 1) * B]),
             'points': traffic_gen._host(pts[i * B:(i + 1) * B]),
             'values': traffic_gen._host(vals[i * B:(i + 1) * B]),
             'trans_mat': cam} for i in range(nb)]


@torch.no_grad()
def sdf_grid(P, cfg: Dict, img: torch.Tensor, resolution: int,
             chunk: int = 32768, low: bool = False) -> torch.Tensor:
    """The (R, R, R) raw SDF of one image (1, H, W, 3) at the grid
    ``linspace(bb_min, bb_max, R)`` (x-major)."""
    enc = encode(P, cfg, img)
    ax = torch.linspace(cfg['bb_min'], cfg['bb_max'], resolution,
                        device=img.device, dtype=torch.float64)
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing='ij')
    pts = torch.stack([X, Y, Z], -1).reshape(1, -1, 3).to(img.dtype)
    out = torch.cat([decode(P, cfg, pts[:, s:s + chunk], enc, low)[0]
                     for s in range(0, pts.shape[1], chunk)])
    return out.reshape((resolution,) * 3)


def prepare_mesh(cfg: Dict, tr: Dict, w: Dict[str, torch.Tensor],
                 imgs: np.ndarray, shapes, seed: int, device,
                 log: Callable[[str], None]) -> Dict[str, torch.Tensor]:
    """Set both streams' output layers in ``w`` in place (module
    docstring) -> those leaves, on the host."""
    n = tr['fit_images']
    x = torch.as_tensor(imgs[:n], device=device)
    pts, sdf = traffic_gen.fit_targets(
        dict(cfg, sample_point_density=FIT_DENSITY), shapes, n, FIT_STRIDE,
        seed)
    with model.precision('f32'), torch.no_grad():
        enc = encode(w, cfg, x)
        hs = [torch.cat(f, -1) for f in (
            features(w, cfg, pts[:, s:s + 32768], enc)
            for s in range(0, pts.shape[1], 32768))]
    h = torch.cat(hs, 1)
    del hs, enc
    a = torch.cat([h.reshape(-1, h.shape[-1]),
                   torch.ones_like(h[..., :1]).reshape(-1, 1)], 1).double()
    del h
    y = sdf.reshape(-1).double() * cfg['sdf_scale']
    gram = a.T @ a
    gram.diagonal().add_(FIT_RIDGE * gram.diagonal().mean())
    sol = torch.linalg.solve(gram, a.T @ y).float()
    k = cfg['disn_head'][-1]
    w['stream_g.fc_out.weight'].copy_(sol[None, :k])
    w['stream_l.fc_out.weight'].copy_(sol[None, k:2 * k])
    w['stream_g.fc_out.bias'].copy_(sol[-1:])
    w['stream_l.fc_out.bias'].zero_()
    log(f'fc_out weight norms {float(sol[:k].norm()):.6g} (global), '
        f'{float(sol[k:2 * k].norm()):.6g} (local)')
    return {k: t.detach().cpu().clone() for k, t in w.items()
            if '.fc_out.' in k}


def _mlp_macs(dims: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(dims, dims[1:]))


def vgg_flops(cfg: Dict) -> int:
    """The encoder's convolutions and classifier, one image."""
    r, total = cfg['img_res'], 0
    block = 0
    for b, _, c_in, c in _convs(cfg):
        if b != block:
            r //= 2
            block = b
        total += 2 * r * r * 9 * c_in * c
    return total + 2 * _mlp_macs(_fc_dims(cfg))


def query_macs(cfg: Dict) -> int:
    """Both streams over one query, as the model describes them."""
    total = 0
    for _, feat in _streams(cfg):
        point, head = _stream_dims(cfg, feat)
        total += _mlp_macs(point) + _mlp_macs(head + [1])
    return total


def mesh_flops(cfg: Dict, resolution: int) -> int:
    """One image encoded and its resolution^3 grid decoded query by
    query."""
    return vgg_flops(cfg) + resolution ** 3 * 2 * query_macs(cfg)


def head_macs(cfg: Dict) -> int:
    """The dense decode's head a query, as the program does it: both
    point MLPs, and each stream's head without its image rows (the
    global ones are one bias of the image, the local ones project the
    maps before the sample)."""
    point, head = _stream_dims(cfg, 0)
    return 2 * (_mlp_macs(point) + _mlp_macs(head + [1]))


def head_bound_s(cfg: Dict, n: int, peaks: Dict[str, float]) -> float:
    """The least time of the head over n queries: the larger of its
    operations over the bf16 peak and its bytes over the memory rate.
    Bytes: each query's sampled local feature (bf16) read, its xyz (f32)
    and its SDF (f32) written once, the weights (bf16) once."""
    nbytes = n * (2 * cfg['disn_head'][0] + 12 + 4) + 2 * head_macs(cfg)
    return max(2 * n * head_macs(cfg) / peaks['bf16_flops'],
               nbytes / peaks['hbm_bytes_s'])
