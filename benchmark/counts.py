"""Operations and bytes of the model's work, from a configuration's shapes.

These count the work the model asks for, whatever implements it, so that a
later change to a kernel or a plan leaves the yardstick where it was.  A
FLOP is a multiply or an add: a multiply-add counts 2.  The model FLOPs
count the convolutions and linear layers; samplers, resizes, norms,
activations and losses are left out.  A training step counts 3 forward
passes (forward, and a backward of twice its cost), recomputation not
included.

The kernel bounds (``k1_bound_s``, ``stencil_step_bound_s``) are the least
time the card could take for a kernel's share of the work: the larger of
its operations over the peak rate and its bytes over the memory rate,
each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

RESNET_FILTERS = (64, 64, 128, 256, 512)
RESNET_FC = 1000
IMAGE_FEAT = 128
POINT_MLP = (64, 256, 512)
ST_HIDDEN = 128
TREE_SUPPORT = 10


def vox_scales(layers: Sequence[int], vox_res: int) -> List[Tuple[int, int]]:
    """(resolution, channels) of each VoxelEncoder2 feature scale: the
    sigmoid map, then one scale a layer from the fourth, each before its
    2x pooling."""
    L = list(layers)
    out, r = [(vox_res, L[3])], vox_res
    for l in range(3, len(L) - 1):
        out.append((r, L[l + 1]))
        r //= 2
    return out


def decoder_in_dim(layers: Sequence[int]) -> int:
    """7 displaced samples of every scale, the perceptual pyramid, xyz."""
    return 7 * sum(c for _, c in vox_scales(layers, 2 ** 10)) \
        + sum(RESNET_FILTERS) + 3


def decoder_flop_per_query(in_dim: int, h_dim: int) -> int:
    """The SDF decoder's in_dim-2h-h-h-1 MLP, one query."""
    return 2 * (in_dim * 2 * h_dim + 2 * h_dim * h_dim + h_dim * h_dim
                + h_dim)


def conv_flops(out_pixels: int, c_in: int, c_out: int, taps: int) -> int:
    return 2 * out_pixels * c_in * c_out * taps


def resnet18_flops(img_res: int) -> int:
    """ResNet18 with the stride-1 7x7 conv1, its fc (512 -> 1000) and fc1
    (1000 -> 128), one image."""
    f = RESNET_FILTERS
    r = img_res
    total = conv_flops(r * r, 3, f[0], 49)
    r = (r + 2 - 3) // 2 + 1  # max pool 3, stride 2, pad 1
    c_in = f[0]
    for li, stride in zip(range(1, 5), (1, 2, 2, 2)):
        c = f[li]
        r = (r - 1) // stride + 1
        total += conv_flops(r * r, c_in, c, 9) + conv_flops(r * r, c, c, 9)
        if stride != 1 or c_in != c:
            total += conv_flops(r * r, c_in, c, 1)
        total += 2 * conv_flops(r * r, c, c, 9)
        c_in = c
    return total + 2 * (f[4] * RESNET_FC + RESNET_FC * IMAGE_FEAT)


def treegcn_flops(features: Sequence[int], degrees: Sequence[int],
                  support: int = TREE_SUPPORT) -> int:
    """TreeGCN from one node to prod(degrees) points, one image: the root
    maps of every ancestor, the branching and the two loop maps a layer."""
    total, node, nodes = 0, 1, [1]
    for d in range(len(features) - 1):
        f_in, f_out, deg = features[d], features[d + 1], degrees[d]
        total += sum(2 * nodes[i] * features[i] * f_out for i in range(d + 1))
        total += 2 * node * f_in * deg * f_in
        total += 2 * node * deg * (f_in * f_in * support
                                   + f_in * support * f_out)
        node *= deg
        nodes.append(node)
    return total


def point_mlp_flops(n_points: int) -> int:
    dims = (3,) + POINT_MLP
    return 2 * n_points * sum(a * b for a, b in zip(dims, dims[1:]))


def spatial_transformer_flops() -> int:
    i = RESNET_FILTERS[4] + IMAGE_FEAT
    return 2 * (i * ST_HIDDEN + ST_HIDDEN * ST_HIDDEN + ST_HIDDEN * 12)


def vox_encoder_flops(layers: Sequence[int], vox_res: int) -> int:
    """VoxelEncoder2's 3x3x3 convolutions, one volume: one a layer, a
    second from the fourth layer on, then a 2x pooling."""
    L, r, total = list(layers), vox_res, 0
    for l in range(len(L) - 1):
        total += conv_flops(r ** 3, L[l], L[l + 1], 27)
        if l >= 3:
            total += conv_flops(r ** 3, L[l + 1], L[l + 1], 27)
            r //= 2
    return total


def n_points(cfg: Dict) -> int:
    n = 1
    for d in cfg['point_degree']:
        n *= d
    return n


def list_encode_flops(cfg: Dict) -> int:
    """LIST's query-independent work, one image."""
    return (2 * resnet18_flops(cfg['img_res'])
            + treegcn_flops(cfg['point_feat'], cfg['point_degree'])
            + point_mlp_flops(n_points(cfg)) + spatial_transformer_flops()
            + vox_encoder_flops(cfg['im_enc_layers'], cfg['vox_res']))


def train_queries(cfg: Dict) -> int:
    """Queries a sample: rint(distribution x density), summed."""
    return sum(int(round(d * cfg['sample_point_density']))
               for d in cfg['sample_distribution'])


def list_train_step_flops(cfg: Dict) -> int:
    per = list_encode_flops(cfg) + train_queries(cfg) * decoder_flop_per_query(
        decoder_in_dim(cfg['im_enc_layers']), cfg['h_dim'])
    return 3 * cfg['train_batch_size'] * per


def coarsenet_train_step_flops(cfg: Dict) -> int:
    per = resnet18_flops(cfg['img_res']) + treegcn_flops(
        cfg['point_feat'], cfg['point_degree'])
    return 3 * cfg['train_batch_size'] * per


def mesh_flops(cfg: Dict, resolution: int) -> int:
    """One image encoded and its resolution^3 grid decoded query by
    query."""
    return list_encode_flops(cfg) + resolution ** 3 * decoder_flop_per_query(
        decoder_in_dim(cfg['im_enc_layers']), cfg['h_dim'])


def _bound(flops: float, nbytes: float, flop_rate: float,
           byte_rate: float) -> float:
    return max(flops / flop_rate, nbytes / byte_rate)


def k1_bound_s(cfg: Dict, n: int, peaks: Dict[str, float]) -> float:
    """The dense decode's fused head over n queries: fc_0 over the seven
    displaced samples of every scale finer than ``coarse_proj_res`` (the
    coarser scales' fc_0 term, the perceptual term and xyz arrive as inputs)
    and the head's tail, in bf16 with f32 accumulation.  Bytes: the parts
    (bf16), the coarse and perceptual terms (bf16, 2h wide), xyz (f32),
    the weights once and the f32 output."""
    d1, h = 2 * cfg['h_dim'], cfg['h_dim']
    k = 7 * sum(c for r, c in vox_scales(cfg['im_enc_layers'],
                                         cfg['vox_res'])
                if r > cfg['coarse_proj_res'])
    macs = n * (k * d1 + d1 * h + h * h + h)
    per_q = 2 * k + 2 * d1 + 2 * d1 + 4 * 3 + 4
    wbytes = 2 * (k * d1 + d1 * h + h * h + h) + 4 * (3 * d1 + d1 + 2 * h + 1)
    return _bound(2 * macs, n * per_q + wbytes, peaks['bf16_flops'],
                  peaks['hbm_bytes_s'])


def stencil_calls(cfg: Dict) -> List[Tuple[int, int, int]]:
    """(c_in, c_out, voxels) of every full-resolution 3x3x3 convolution
    call of one LIST train step: the convolutions before the first pooling
    forward (twice under remat), the input gradient of each but the first
    (its input is the occupancy target), and every weight gradient."""
    L = list(cfg['im_enc_layers'])
    vox = cfg['train_batch_size'] * cfg['vox_res'] ** 3
    convs = [(L[l], L[l + 1]) for l in range(min(3, len(L) - 1))]
    if len(L) > 4:
        convs += [(L[3], L[4]), (L[4], L[4])]
    fwd = convs * (2 if cfg['remat'] else 1)
    dx = [(co, ci) for ci, co in convs[1:]]
    dk = convs
    return [(ci, co, vox) for ci, co in fwd + dx + dk]


def stencil_step_bound_s(cfg: Dict, peaks: Dict[str, float]) -> float:
    """Summed bounds of one step's stencil calls, in f32 off the tensor
    cores: each reads a c_in and a c_out volume (or writes one of them) and
    the 27 c_in x c_out weights."""
    return sum(_bound(2 * 27 * ci * co * v,
                      4 * v * (ci + co) + 4 * 27 * ci * co,
                      peaks['f32_flops'], peaks['hbm_bytes_s'])
               for ci, co, v in stencil_calls(cfg))
