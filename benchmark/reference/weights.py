"""The models' parameters, listed from a configuration, and their values
made from a seed.

Both sides of a comparison get these values: the program loads them into
its model by name, the reference makes them again from the same seed.
The names are the models' ``state_dict`` keys; a model's ``spec`` (its
reference module's, ``reference/models/``) lists each with its shape and
how it starts:

- ``w``: a weight, normal with standard deviation ``gain / sqrt(fan_in)``
  (He's, gain sqrt(2), for the ReLU networks; TreeGCN's branching
  weights use its own LeakyReLU gain);
- ``zero`` / ``one``: a bias or a BatchNorm shift / a BatchNorm scale;
- ``mean`` / ``var``: BatchNorm running statistics (0 and 1);
- ``proj``: the spatial transformer's output bias, a fixed camera: the
  (4, 3) matrix that maps a decoder query (q0, q1, q2, 1) to the pixel
  (68 + 60 q0, 68 - 60 q1) of the 137^2 feature maps at depth 1, with
  small output weights (gain 0.01) around it, so that random weights
  project the queries into the image as a trained model's camera does.

``make`` draws every value in a few calls on the device: one normal
vector over all leaves, scaled and shifted by per-element factors.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

RESNET_FILTERS = (64, 64, 128, 256, 512)
POINT_MLP = (64, 256, 512)
SUPPORT = 10
HE = math.sqrt(2.0)
LEAKY = math.sqrt(2.0 / (1.0 + 0.2 ** 2))

Leaf = Tuple[str, Tuple[int, ...], str, float]


def stream_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f'{int(seed)}:{what}'.encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


def _bn(name: str, c: int) -> List[Leaf]:
    return [(f'{name}.weight', (c,), 'one', 0.0),
            (f'{name}.bias', (c,), 'zero', 0.0),
            (f'{name}.running_mean', (c,), 'mean', 0.0),
            (f'{name}.running_var', (c,), 'var', 0.0)]


def _linear(name: str, c_in: int, c_out: int, bias: bool = True,
            gain: float = HE) -> List[Leaf]:
    out = [(f'{name}.weight', (c_out, c_in), 'w', gain / math.sqrt(c_in))]
    if bias:
        out.append((f'{name}.bias', (c_out,), 'zero', 0.0))
    return out


def _conv(name: str, c_in: int, c_out: int, k: Tuple[int, ...],
          bias: bool) -> List[Leaf]:
    fan = c_in * math.prod(k)
    out = [(f'{name}.weight', (c_out, c_in) + k, 'w', HE / math.sqrt(fan))]
    if bias:
        out.append((f'{name}.bias', (c_out,), 'zero', 0.0))
    return out


def resnet_spec(pre: str) -> List[Leaf]:
    f = RESNET_FILTERS
    out = _conv(f'{pre}.conv1', 3, f[0], (7, 7), False) + _bn(f'{pre}.bn1',
                                                               f[0])
    c_in = f[0]
    for li, stride in zip(range(1, 5), (1, 2, 2, 2)):
        for bi in range(2):
            b, ci = f'{pre}.layer{li}_{bi}', (c_in if bi == 0 else f[li])
            out += _conv(f'{b}.conv1', ci, f[li], (3, 3), False)
            out += _bn(f'{b}.bn1', f[li])
            out += _conv(f'{b}.conv2', f[li], f[li], (3, 3), False)
            out += _bn(f'{b}.bn2', f[li])
            if bi == 0 and (stride != 1 or ci != f[li]):
                out += _conv(f'{b}.downsample_conv', ci, f[li], (1, 1),
                             False)
                out += _bn(f'{b}.downsample_bn', f[li])
        c_in = f[li]
    return out + _linear(f'{pre}.fc', f[4], 1000) + _linear(f'{pre}.fc1',
                                                            1000, 128)


def tree_spec(pre: str, features, degrees) -> List[Leaf]:
    out, node, n = [], 1, len(features) - 1
    for d in range(n):
        g, f_in, f_out, deg = (f'{pre}.TreeGCN_{d}', features[d],
                               features[d + 1], degrees[d])
        for i in range(d + 1):
            out += _linear(f'{g}.W_root_{i}', features[i], f_out, False)
        out.append((f'{g}.W_branch', (node, f_in, deg * f_in), 'w',
                    LEAKY / math.sqrt(f_in * deg * f_in)))
        out += _linear(f'{g}.W_loop_0', f_in, f_in * SUPPORT, False)
        out += _linear(f'{g}.W_loop_1', f_in * SUPPORT, f_out, False)
        if d != n - 1:
            out.append((f'{g}.bias', (1, deg, f_out), 'zero', 0.0))
        node *= deg
    return out


def vox_channels(layers) -> Tuple[int, ...]:
    L = list(layers)
    return (L[3],) + tuple(L[l + 1] for l in range(3, len(L) - 1))


def list_spec(cfg: Dict) -> List[Leaf]:
    L, h = list(cfg['im_enc_layers']), cfg['h_dim']
    out = []
    for l in range(len(L) - 1):
        out += _conv(f'vox_encoder.conv_{l}', L[l], L[l + 1], (3, 3, 3), True)
        if l < 2:
            out += _bn(f'vox_encoder.bn_{l}', L[l + 1])
        elif l > 2:
            out += _conv(f'vox_encoder.conv_{l}_0', L[l + 1], L[l + 1],
                         (3, 3, 3), True)
            out += _bn(f'vox_encoder.bn_{l}', L[l + 1])
    in_dim = 7 * sum(vox_channels(L)) + sum(RESNET_FILTERS) + 3
    out += _linear('sdf_decoder.fc_0', in_dim, 2 * h)
    out += _linear('sdf_decoder.fc_1', 2 * h, h)
    out += _linear('sdf_decoder.fc_2', h, h)
    out += _linear('sdf_decoder.fc_out', h, 1, gain=1.0)
    out += resnet_spec('im_encoder') + resnet_spec('im_encoder2')
    out += tree_spec('point_decoder', cfg['point_feat'], cfg['point_degree'])
    c_in = 3
    for i, c in enumerate(POINT_MLP):
        out += _linear(f'point_mlp_coarse.block{i + 1}_conv', c_in, c)
        out += _bn(f'point_mlp_coarse.block{i + 1}_bn', c)
        c_in = c
    st = 'spatial_transformer'
    out += _linear(f'{st}.fc0', RESNET_FILTERS[4] + 128, 128)
    out += _bn(f'{st}.bn0', 128)
    out += _linear(f'{st}.fc1', 128, 128) + _bn(f'{st}.bn1', 128)
    out += [(f'{st}.fc2.weight', (12, 128), 'w', 0.01 / math.sqrt(128)),
            (f'{st}.fc2.bias', (12,), 'proj', 0.0)]
    return out


def coarsenet_spec(cfg: Dict) -> List[Leaf]:
    return resnet_spec('image_encoder') + tree_spec(
        'point_decoder', cfg['point_feat'], cfg['point_degree'])


# (q0, q1, q2, 1) rows -> (u, v, depth) columns, flattened row-major
CAMERA = (60.0, 0.0, 0.0,
          0.0, -60.0, 0.0,
          0.0, 0.0, 0.0,
          68.0, 68.0, 1.0)


def trainable(kind: str) -> bool:
    return kind in ('w', 'zero', 'one', 'proj')


def make(leaves: List[Leaf], seed: int, device, dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``leaves`` (a model's ``spec(cfg)``), made on
    ``device`` from ``seed``."""
    sizes = [math.prod(s) for _, s, _, _ in leaves]
    scale = torch.tensor([std if k == 'w' else 0.0
                          for _, _, k, std in leaves], dtype=dtype)
    shift = torch.tensor([1.0 if k in ('one', 'var') else 0.0
                          for _, _, k, _ in leaves], dtype=dtype)
    counts = torch.tensor(sizes)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 'weights'))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    flat.mul_(scale.to(device).repeat_interleave(counts.to(device),
                                                 output_size=flat.numel()))
    flat.add_(shift.to(device).repeat_interleave(counts.to(device),
                                                 output_size=flat.numel()))
    offset = 0
    for (_, _, k, _), n in zip(leaves, sizes):
        if k == 'proj':
            flat[offset:offset + n] = torch.tensor(CAMERA, dtype=dtype)
        offset += n
    # each leaf in storage of its own: kernels (cuDNN's training
    # BatchNorm among them) refuse operands at unaligned offsets
    return {name: part.view(shape).clone() for (name, shape, _, _), part
            in zip(leaves, flat.split(sizes))}
