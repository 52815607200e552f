"""Plain PyTorch reference of LIST (stage 2) and CoarseNet (stage 1).

Written from the models' published description, as functions of a dict of
parameters named as in ``weights.list_spec`` and ``coarsenet_spec``:
ResNet18 encoders with a stride-1 7x7 first convolution, the TreeGCN
point decoder, the per-point MLP and the spatial transformer,
nearest-point voxelization of the coarse cloud, ``VoxelEncoder2``, and
the SDF decoder over 7 displaced trilinear samples of every voxel scale
plus the perceptual features of the projected query.
``torch.nn.functional`` does the convolutions, norms, resizes and grid
samples; no kernel, cache or plan of the program is used.

Departures from the original torch LIST that the program makes too and
the configuration states: BatchNorm over the whole batch with eps 1e-5;
voxelization inside the model; the occupancy loss's log arguments clamped
at 1e-8; in training the voxel features rounded to bfloat16 and back
(``vox_packed_dtype``), the occupancy prediction taken before the
rounding.

``precision`` sets how matrix products and convolutions round: ``f32``
(TF32 off, the reference; its 3D convolutions in float64, rounded to
float32, see ``conv3d``), ``tf32`` (TF32 on) and ``fp8`` (TF32 for the
encoder, and the SDF decoder's linear layers on operands rounded to
float8 e4m3 with one scale a tensor): the controls.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5
DELTA = 0.0722
PERCEP_MAP = 137
OCC_W = 0.9


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on for ``tf32`` and ``fp8``, off for ``f32``; restored after."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = mode in ('tf32', 'fp8')
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude to
    448) and back."""
    s = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
    return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s


def _bn(P, name: str, x: torch.Tensor, train) -> torch.Tensor:
    """``train``: False normalizes with the running statistics, True with
    the batch's, and a dict with the batch's, recorded into it by name
    (mean and biased variance)."""
    if isinstance(train, dict):
        var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())),
                                   correction=0)
        train[name] = (mean, var)
    if train is not False:
        return F.batch_norm(x, None, None, P[f'{name}.weight'],
                            P[f'{name}.bias'], True, 0.0, EPS)
    return F.batch_norm(x, P[f'{name}.running_mean'],
                        P[f'{name}.running_var'], P[f'{name}.weight'],
                        P[f'{name}.bias'], False, 0.0, EPS)


def _lin(P, name: str, x: torch.Tensor, low: bool = False) -> torch.Tensor:
    w, b = P[f'{name}.weight'], P.get(f'{name}.bias')
    if low:
        return F.linear(fp8(x), fp8(w), b)
    return F.linear(x, w, b)


def resnet(P, pre: str, img: torch.Tensor, train: bool):
    """img (B, H, W, 3) -> (128-d feature (B, 128), NCHW pyramid
    [conv1, layer1..layer4])."""
    h = img.permute(0, 3, 1, 2)
    f0 = F.relu(_bn(P, f'{pre}.bn1', F.conv2d(h, P[f'{pre}.conv1.weight'],
                                              padding=3), train))
    h = F.max_pool2d(f0, 3, 2, 1)
    feats = [f0]
    for li, stride in zip(range(1, 5), (1, 2, 2, 2)):
        for bi in range(2):
            b, s = f'{pre}.layer{li}_{bi}', (stride if bi == 0 else 1)
            out = F.relu(_bn(P, f'{b}.bn1', F.conv2d(
                h, P[f'{b}.conv1.weight'], stride=s, padding=1), train))
            out = _bn(P, f'{b}.bn2', F.conv2d(out, P[f'{b}.conv2.weight'],
                                               padding=1), train)
            if f'{b}.downsample_conv.weight' in P:
                h = _bn(P, f'{b}.downsample_bn', F.conv2d(
                    h, P[f'{b}.downsample_conv.weight'], stride=s), train)
            h = F.relu(out + h)
        feats.append(h)
    v = _lin(P, f'{pre}.fc1', _lin(P, f'{pre}.fc', h.mean(dim=(2, 3))))
    return v, feats


def tree_decoder(P, pre: str, feat: torch.Tensor, features, degrees
                 ) -> torch.Tensor:
    """TreeGCN: a 1-node tree of the image feature grown to
    prod(degrees) points of features[-1] values."""
    tree, node, n, B = [feat[:, None, :]], 1, len(features) - 1, feat.shape[0]
    for d in range(n):
        g, f_in, f_out, deg = (f'{pre}.TreeGCN_{d}', features[d],
                               features[d + 1], degrees[d])
        root = 0.0
        for i in range(d + 1):
            rn = F.linear(tree[i], P[f'{g}.W_root_{i}.weight'])
            root = root + rn.repeat(1, 1, node // tree[i].shape[1]).view(
                B, -1, f_out)
        br = torch.einsum('bni,nij->bnj', tree[-1], P[f'{g}.W_branch'])
        br = F.leaky_relu(br, 0.2).reshape(B, node * deg, f_in)
        br = F.linear(F.linear(br, P[f'{g}.W_loop_0.weight']),
                      P[f'{g}.W_loop_1.weight'])
        br = root.repeat(1, 1, deg).view(B, -1, f_out) + br
        if d != n - 1:
            br = F.leaky_relu(br + P[f'{g}.bias'].repeat(1, node, 1), 0.2)
        tree.append(br)
        node *= deg
    return tree[-1]


def point_mlp(P, pre: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    for i in (1, 2, 3):
        x = _lin(P, f'{pre}.block{i}_conv', x)
        s = x.shape
        x = F.relu(_bn(P, f'{pre}.block{i}_bn', x.reshape(-1, s[-1]),
                       train)).reshape(s)
    return x


def spatial_transformer(P, x: torch.Tensor, train: bool) -> torch.Tensor:
    st = 'spatial_transformer'
    x = _bn(P, f'{st}.bn0', F.leaky_relu(_lin(P, f'{st}.fc0', x), 0.2), train)
    x = _bn(P, f'{st}.bn1', F.leaky_relu(_lin(P, f'{st}.fc1', x), 0.2), train)
    return _lin(P, f'{st}.fc2', x).reshape(-1, 4, 3)


def voxelize(pc: torch.Tensor, bb_min: float, bb_max: float, res: int
             ) -> torch.Tensor:
    """(B, N, 3) -> (B, res, res, res) occupancy of the nearest grid
    points (round half to even, clamped), axes (x, y, z)."""
    step = (bb_max - bb_min) / (res - 1)
    ijk = torch.round((pc.detach() - bb_min) / step).clamp(0, res - 1).long()
    flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    occ = torch.zeros(pc.shape[0], res ** 3, dtype=pc.dtype, device=pc.device)
    occ.scatter_(1, flat, 1.0)
    return occ.view(-1, res, res, res)


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """3x3x3 SAME convolution.  With TF32 off (the reference) a float32
    convolution computes in float64 and rounds back: cuDNN's float32
    weight gradient of the 16 -> 16 convolution at 8 x 128^3 sums 16.8M
    voxels that nearly cancel under the BatchNorm after it, and was found
    up to a third off in norm against float64 (PERF.md)."""
    if x.dtype != torch.float32 or torch.backends.cudnn.allow_tf32:
        return F.conv3d(x, w, b, padding=1)
    return F.conv3d(x.double(), w.double(), b.double(), padding=1).float()


def vox_encoder(P, occ: torch.Tensor, layers, train: bool):
    """occ (B, R, R, R) -> (NCDHW feature scales, occupancy prediction)."""
    L, net, feats, occ_pred = list(layers), occ[:, None], [], None

    def conv(x, name):
        return conv3d(x, P[f'{name}.weight'], P[f'{name}.bias'])

    for l in range(len(L) - 1):
        c = f'vox_encoder.conv_{l}'
        if l < 2:
            net = _bn(P, f'vox_encoder.bn_{l}', F.relu(conv(net, c)), train)
        elif l == 2:
            net = torch.sigmoid(conv(net, c))
            occ_pred = net[:, 0]
            feats.append(net)
        else:
            net = F.relu(conv(net, c))
            net = F.relu(conv(net, f'{c}_0'))
            net = _bn(P, f'vox_encoder.bn_{l}', net, train)
            feats.append(net)
            net = F.max_pool3d(net, 2)
    if train is True:
        feats = [f.to(torch.bfloat16).to(f.dtype) for f in feats]
    return feats, occ_pred


def encode(P, cfg: Dict, img: torch.Tensor, train) -> Dict:
    """The query-independent work of LIST for a batch of images; ``train``
    as ``_bn`` takes it (the voxel features are rounded as in training only
    for True)."""
    feat_g, _ = resnet(P, 'im_encoder', img, train)
    feat_g2, pyramid = resnet(P, 'im_encoder2', img, train)
    pc = tree_decoder(P, 'point_decoder', feat_g, cfg['point_feat'],
                      cfg['point_degree'])
    coarse = point_mlp(P, 'point_mlp_coarse', pc, train).amax(dim=1)
    trans_mat = spatial_transformer(P, torch.cat([coarse, feat_g2], 1), train)
    occ = voxelize(pc, cfg['bb_min'], cfg['bb_max'], cfg['vox_res'])
    vox, occ_pred = vox_encoder(P, occ, cfg['im_enc_layers'], train)
    fmaps = torch.cat([F.interpolate(f, size=(PERCEP_MAP, PERCEP_MAP),
                                     mode='bilinear', align_corners=True)
                       for f in pyramid], 1)
    return dict(pc=pc, trans_mat=trans_mat, vox=vox, occ_pred=occ_pred,
                fmaps=fmaps)


def displacements(device, dtype) -> torch.Tensor:
    d = [[0.0, 0.0, 0.0]]
    for ax in range(3):
        for s in (-1.0, 1.0):
            v = [0.0, 0.0, 0.0]
            v[ax] = s * DELTA
            d.append(v)
    return torch.tensor(d, device=device, dtype=dtype)


def percep(fmaps: torch.Tensor, q: torch.Tensor, trans_mat: torch.Tensor
           ) -> torch.Tensor:
    """Bilinear samples (zeros outside, align corners) of the 137^2 maps at
    the queries projected through the learned (B, 4, 3) matrix -> (B, N,
    C)."""
    homo = torch.cat([q, torch.ones_like(q[..., :1])], -1)
    xyz = torch.einsum('bnk,bkj->bnj', homo, trans_mat)
    xy = (xyz[..., :2] / (xyz[..., 2:] + 1e-8)).clamp(0.0, PERCEP_MAP - 1.0)
    half = (PERCEP_MAP - 1) / 2.0
    s = F.grid_sample(fmaps, ((xy - half) / half)[:, None], mode='bilinear',
                      padding_mode='zeros', align_corners=True)
    return s[:, :, 0].transpose(1, 2)


def decode(P, query: torch.Tensor, enc: Dict, low: bool = False
           ) -> torch.Tensor:
    """query (B, N, 3) world coordinates -> (B, N) raw SDF (sdf_scale
    units); ``low``: the fp8 decoder of the control."""
    x = decoder_features(P, query, enc, low)
    return _lin(P, 'sdf_decoder.fc_out', x, low)[..., 0]


def decoder_features(P, query: torch.Tensor, enc: Dict, low: bool = False
                     ) -> torch.Tensor:
    """The SDF decoder up to ``fc_out``: (B, N, 3) -> (B, N, h_dim)."""
    q = query[..., [2, 1, 0]] * 2.0
    B, N, _ = q.shape
    pd = (q[:, None] + displacements(q.device, q.dtype)[None, :, None]
          ).reshape(B, 1, 1, 7 * N, 3)
    vox = []
    for f in enc['vox']:
        s = F.grid_sample(f, pd, mode='bilinear', padding_mode='border',
                          align_corners=True)
        vox.append(s.reshape(B, f.shape[1], 7, N).permute(0, 3, 1, 2))
    x = torch.cat([torch.cat(vox, 2).reshape(B, N, -1),
                   percep(enc['fmaps'], q, enc['trans_mat']), q], -1)
    for name in ('fc_0', 'fc_1', 'fc_2'):
        x = F.relu(_lin(P, f'sdf_decoder.{name}', x, low))
    return x


def occupancy_loss(occ_pred: torch.Tensor, occ_gt: torch.Tensor,
                   w: float = OCC_W) -> torch.Tensor:
    """Weighted BCE x 1000, log arguments clamped at 1e-8."""
    la = torch.log((occ_pred + 1e-8).clamp_min(1e-8))
    lb = torch.log((1 - occ_pred + 1e-8).clamp_min(1e-8))
    return 1000.0 * (-w * (occ_gt * la).mean()
                     - (1 - w) * ((1 - occ_gt) * lb).mean())


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor, rows: int = 512
                 ) -> torch.Tensor:
    """1000 x the mean over the batch of the two mean squared nearest
    distances, from the coordinate differences (no |x|^2 + |y|^2 - 2xy
    cancellation)."""
    fwd, bwd = [], None
    for s in range(0, pred.shape[1], rows):
        d2 = ((pred[:, s:s + rows, None] - gt[:, None]) ** 2).sum(-1)
        fwd.append(d2.min(dim=2).values)
        m = d2.min(dim=1).values
        bwd = m if bwd is None else torch.minimum(bwd, m)
    return 1000.0 * (torch.cat(fwd, 1).mean(1) + bwd.mean(1)).mean()


def list_losses(P, cfg: Dict, batch: Dict, chunk: int,
                low: bool = False) -> Dict[str, torch.Tensor]:
    """One training forward and backward of LIST on a device batch; the
    gradients land in ``P``'s leaves.  The decoder runs over chunks of
    ``chunk`` queries, each chunk's loss backpropagated into detached
    copies of the encoding, whose gradients then go through the encoder
    once: the same gradient as one pass over all queries (the decoder has
    no batch statistics)."""
    enc = encode(P, cfg, batch['rgb_image'], True)
    occ = occupancy_loss(enc['occ_pred'], batch['occ'])
    outs = list(enc['vox']) + [enc['fmaps'], enc['trans_mat']]
    cut = [t.detach().requires_grad_() for t in outs]
    d = dict(vox=cut[:-2], fmaps=cut[-2], trans_mat=cut[-1])
    scale, B = cfg['sdf_scale'], batch['points'].shape[0]
    sdf = 0.0
    for s in range(0, batch['points'].shape[1], chunk):
        pred = decode(P, batch['points'][:, s:s + chunk], d, low)
        part = ((batch['values'][:, s:s + chunk] * scale - pred) ** 2
                ).sum() / B
        part.backward()
        sdf = sdf + part.detach()
    torch.autograd.backward([occ] + outs,
                            [torch.ones_like(occ)] + [c.grad for c in cut])
    return {'occ_loss': occ.detach(), 'sdf_loss': sdf}


def coarsenet_losses(P, cfg: Dict, batch: Dict, chunk: int = 0,
                     low: bool = False) -> Dict[str, torch.Tensor]:
    feat, _ = resnet(P, 'image_encoder', batch['rgb_image'], True)
    pc = tree_decoder(P, 'point_decoder', feat, cfg['point_feat'],
                      cfg['point_degree'])
    loss = chamfer_loss(pc, batch['pc'])
    loss.backward()
    return {'chamfer_loss': loss.detach()}


@torch.no_grad()
def batch_statistics(P, cfg: Dict, imgs: torch.Tensor) -> Dict:
    """{BatchNorm name: (mean, biased variance)} of LIST's encoder over
    ``imgs`` in training mode: running statistics that fit the inputs, as
    a trained model's do."""
    stats: Dict = {}
    encode(P, cfg, imgs, stats)
    return stats


@torch.no_grad()
def fit_features(P, cfg: Dict, imgs: torch.Tensor, points: torch.Tensor,
                 chunk: int = 32768) -> torch.Tensor:
    """The SDF decoder's features before ``fc_out`` (eval mode) at
    ``points`` (B, N, 3) of ``imgs`` (B, H, W, 3) -> (B, N, h_dim)."""
    enc = encode(P, cfg, imgs, False)
    return torch.cat([decoder_features(P, points[:, s:s + chunk], enc)
                      for s in range(0, points.shape[1], chunk)], 1)


@torch.no_grad()
def sdf_grid(P, cfg: Dict, img: torch.Tensor, resolution: int,
             chunk: int = 32768, low: bool = False,
             points: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (R, R, R) raw SDF of one image (1, H, W, 3) at the grid
    ``linspace(bb_min, bb_max, R)`` (x-major), in eval mode; ``points``
    (N, 3): those points instead, -> (N,)."""
    enc = encode(P, cfg, img, False)
    if points is None:
        ax = torch.linspace(cfg['bb_min'], cfg['bb_max'], resolution,
                            device=img.device, dtype=torch.float64)
        X, Y, Z = torch.meshgrid(ax, ax, ax, indexing='ij')
        points = torch.stack([X, Y, Z], -1).reshape(-1, 3).to(img.dtype)
    out = [decode(P, points[None, s:s + chunk], enc, low)[0]
           for s in range(0, points.shape[0], chunk)]
    out = torch.cat(out)
    return out.reshape((resolution,) * 3) if out.numel() == resolution ** 3 \
        else out
