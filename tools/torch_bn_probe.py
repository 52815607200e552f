#!/usr/bin/env python3
"""Every BatchNorm shape of the benchmark's cells on one NVIDIA GPU: cuDNN
(``F.batch_norm``, and the module's training forward where the kernels do
not take the shape, ``torch.var_mean`` then ``F.batch_norm``) against
``list_tpu_torch/ops/cuda/batch_norm.py`` and the plain versions:

    python3 tools/torch_bn_probe.py [--reps 20] [--out build/bn_probe.json]

Shapes: the voxel encoder's seven and the ResNet18's five BatchNorm
inputs (conv1 at 224^2, then layer1-4) at batch 8 (``list.train``), the
ResNet's at 16 (``coarsenet.train``), all at batch 1 in eval
(``list.mesh128``); the 2-D ones (PointMLP, the spatial transformer) are
outside the kernels' scope.  For each: the training forward, the backward
and the eval forward in ms, CUDA events over ``--reps`` calls, two rounds
in turns (cuDNN, the wrapper, the wrapper, cuDNN; cuDNN on the ResNets'
channels-last inputs as the program gives them, the wrapper on a
contiguous copy, which it needs).  The training forward three ways:
``module``, ``batch_norm_train`` as ``BatchNorm`` runs it on a routed
shape (the kernels' statistics and normalize where ``normalizes(C)``,
else cuDNN's one call); ``kernels``, the kernels' statistics and
normalize at any C; ``var_mean``, ``torch.var_mean`` then
``F.batch_norm``.  The backward is the kernels' from the module's
statistics.  Also the kernels' bound (bytes at the data-sheet rate);
whether ``routes`` takes the shape; and, for the voxel shapes, the
module's, the kernels' and cuDNN's largest error against float64 with
max|float64| beside it.  One JSON line a shape, then the whole.
"""

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from list_tpu_torch.ops.cuda import batch_norm as bn  # noqa: E402

EPS = bn.EPS
VOXEL = [('bn_0', 1, 128), ('bn_1', 1, 128), ('bn_3', 16, 128),
         ('bn_4', 32, 64), ('bn_5', 64, 32), ('bn_6', 128, 16),
         ('bn_7', 128, 8)]
RESNET = [('bn1', 64, 224), ('layer1', 64, 112), ('layer2', 128, 56),
          ('layer3', 256, 28), ('layer4', 512, 14)]
CASES = ([('voxel', n, 'train', (8, c, r, r, r)) for n, c, r in VOXEL]
         + [('resnet', n, 'train', (8, c, r, r)) for n, c, r in RESNET]
         + [('resnet', n, 'train', (16, c, r, r)) for n, c, r in RESNET]
         + [('voxel', n, 'eval', (1, c, r, r, r)) for n, c, r in VOXEL]
         + [('resnet', n, 'eval', (1, c, r, r)) for n, c, r in RESNET])


def card() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi failed: {e}'


def timed(fn, reps: int) -> float:
    """ms a call: CUDA events over ``reps`` calls after two warm ones."""
    for _ in range(2):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(paths: dict, reps: int) -> dict:
    """{path: [round 1 ms, round 2 ms]}, the second round reversed."""
    out = {k: [] for k in paths}
    for order in (list(paths), list(paths)[::-1]):
        for k in order:
            out[k].append(timed(paths[k], reps))
    return out


def err(got, ref) -> float:
    return float((got.double() - ref).abs().max())


def layout(x, net: str):
    """The ResNets' BatchNorm inputs are channels-last (their convolutions
    take the NHWC images permuted), so cuDNN takes its NHWC kernels."""
    return x.to(memory_format=torch.channels_last) if net == 'resnet' else x


def train_case(net, shape, reps: int, check: bool) -> dict:
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    c = shape[1]
    x = 3.0 + torch.randn(shape, device=dev, generator=g)
    dy = torch.randn(shape, device=dev, generator=g)
    w = 1.0 + 0.5 * torch.randn(c, device=dev, generator=g)
    b = torch.randn(c, device=dev, generator=g)
    dims = [0] + list(range(2, x.dim()))
    xl, dyl = layout(x, net), layout(dy, net)
    xr, wr, br = (t.clone().requires_grad_() for t in (xl, w, b))
    y_cudnn = F.batch_norm(xr, None, None, wr, br, True, 0.0, EPS)
    _, mean, _, rstd = bn._forward_train(x, w, b)

    def kernels_fwd():
        m, _, r = bn._stats(x)
        return bn._apply(x, m, r, w, b, False)

    def var_mean_fwd():
        torch.var_mean(xl, dim=dims, correction=0)
        F.batch_norm(xl, None, None, w, b, True, 0.0, EPS)

    def plain_fwd():
        bn.batch_norm_train_plain(xl, w, b)

    with torch.no_grad():
        fwd = in_turns(dict(
            cudnn=lambda: F.batch_norm(xl, None, None, w, b, True, 0.0, EPS),
            module=lambda: bn.batch_norm_train(x, w, b)), reps)
        fwd.update(in_turns(dict(kernels=kernels_fwd, var_mean=var_mean_fwd),
                            reps))
        fwd.update(in_turns(dict(plain=plain_fwd), max(2, reps // 4)))
    bwd = in_turns(dict(
        cudnn=lambda: torch.autograd.grad(y_cudnn, (xr, wr, br), dyl,
                                          retain_graph=True),
        kernel=lambda: bn._backward(x, dy, w, mean, rstd, True)), reps)
    bwd.update(in_turns(dict(plain=lambda: bn.batch_norm_backward_plain(
        x, dy, w, mean, rstd)), max(2, reps // 4)))
    rec = dict(fwd_ms=fwd, bwd_ms=bwd)
    if check:
        x64, w64, b64, dy64 = (t.double() for t in (x, w, b, dy))
        y64, m64, v64 = bn.batch_norm_train_plain(x64, w64, b64)
        r64 = torch.rsqrt(v64 + EPS)
        dx64, dw64, db64 = bn.batch_norm_backward_plain(x64, dy64, w64, m64,
                                                        r64)
        gx, gw, gb = torch.autograd.grad(y_cudnn, (xr, wr, br), dy)
        rec['max_abs_err'] = {}
        for name in ('module', 'kernels'):
            if name == 'module':
                y, m, v, r = bn._forward_train(x, w, b)
            else:
                m, v, r = bn._stats(x)
                y = bn._apply(x, m, r, w, b, False)
            dx, dw, db = bn._backward(x, dy, w, m, r, True)
            rec['max_abs_err'][name] = dict(
                y=err(y, y64), mean=err(m, m64), var=err(v, v64),
                dx=err(dx, dx64), dweight=err(dw, dw64), dbias=err(db, db64))
        rec['max_abs_err'].update(
            cudnn=dict(y=err(y_cudnn, y64), dx=err(gx, dx64),
                       dweight=err(gw, dw64), dbias=err(gb, db64)),
            max_abs_f64=dict(y=float(y64.abs().max()),
                             mean=float(m64.abs().max()),
                             var=float(v64.abs().max()),
                             dx=float(dx64.abs().max()),
                             dweight=float(dw64.abs().max()),
                             dbias=float(db64.abs().max())))
    return rec


def eval_case(net, shape, reps: int, check: bool) -> dict:
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    c = shape[1]
    x = 3.0 + torch.randn(shape, device=dev, generator=g)
    w = 1.0 + 0.5 * torch.randn(c, device=dev, generator=g)
    b = torch.randn(c, device=dev, generator=g)
    rm = 3.0 + 0.1 * torch.randn(c, device=dev, generator=g)
    rv = 0.5 + torch.rand(c, device=dev, generator=g)
    xl = layout(x, net)
    with torch.inference_mode():
        t = in_turns(dict(
            cudnn=lambda: F.batch_norm(xl, rm, rv, w, b, False, 0.0, EPS),
            kernel=lambda: bn.batch_norm_eval(x, rm, rv, w, b)), reps)
        t.update(in_turns(dict(plain=lambda: bn.batch_norm_eval_plain(
            x, rm, rv, w, b)), max(2, reps // 4)))
        rec = dict(eval_ms=t)
        if check:
            ref = bn.batch_norm_eval_plain(*(v.double()
                                             for v in (x, rm, rv, w, b)))
            rec['max_abs_err'] = dict(
                kernel=err(bn.batch_norm_eval(x, rm, rv, w, b), ref),
                cudnn=err(F.batch_norm(x, rm, rv, w, b, False, 0.0, EPS),
                          ref),
                max_abs_f64=float(ref.abs().max()))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('torch_bn_probe: needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = dict(card=card(), sms=sms, torch=torch.__version__,
               cudnn=torch.backends.cudnn.version(), shapes=[])
    print(json.dumps({k: v for k, v in out.items() if k != 'shapes'}),
          flush=True)
    for net, name, mode, shape in CASES:
        c = shape[1]
        m = 1
        for d in shape:
            m *= d
        m //= c
        check = net == 'voxel'
        rec = dict(net=net, name=name, mode=mode, shape=list(shape),
                   routes=bn.routes(len(shape), torch.float32, c, m),
                   geometry=list(bn.geometry(c, m, sms)),
                   bound_ms=bn.bound_ms(shape))
        rec.update(train_case(net, shape, args.reps, check)
                   if mode == 'train'
                   else eval_case(net, shape, args.reps, check))
        print(json.dumps(rec), flush=True)
        out['shapes'].append(rec)
        torch.cuda.empty_cache()
    out['card_after'] = card()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)


if __name__ == '__main__':
    main()
