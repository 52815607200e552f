"""The dense decode's perceptual sample (``ops/cuda/percep.py``) on the
CPU: its plain path is bit for bit the formula LIST's and DISN's decodes
computed inline, in both decodes' coordinate orders; its bound; the
operands the kernel refuses; its launch counter.  The kernel itself runs
on the card only (``tests/test_torch_cuda.py`` ``-k percep``)."""

import os

import pytest
import torch

from list_tpu_torch.ops import dense_grid
from list_tpu_torch.ops.cuda import (KERNEL_SOURCES, build, launch_counts,
                                     percep, reset_launch_counts)

MS = percep.PERCEP_MAP
# a LIST-like learned camera: pixels inside the map, depth near 1
CAMERA = [[60.0, 1.0, 0.1], [2.0, -60.0, 0.05], [0.5, 0.3, 0.02],
          [68.0, 68.0, 1.0]]


def _inline_percep(flat_pm, t, p0, p1, p2, dt):
    """The decodes' perceptual sample as they computed it inline."""
    ms = MS
    n = p0.numel()
    u = p0 * t[0, 0] + p1 * t[1, 0] + p2 * t[2, 0] + t[3, 0]
    v = p0 * t[0, 1] + p1 * t[1, 1] + p2 * t[2, 1] + t[3, 1]
    d = p0 * t[0, 2] + p1 * t[1, 2] + p2 * t[2, 2] + t[3, 2]
    xpix = (u / (d + 1e-8)).clamp(0.0, float(ms - 1))
    ypix = (v / (d + 1e-8)).clamp(0.0, float(ms - 1))
    x0i = torch.floor(xpix).long()
    y0i = torch.floor(ypix).long()
    x1i = (x0i + 1).clamp(max=ms - 1)
    y1i = (y0i + 1).clamp(max=ms - 1)
    wxf = (xpix - x0i.float()).reshape(n, 1).to(dt)
    wyf = (ypix - y0i.float()).reshape(n, 1).to(dt)
    idx = torch.cat([(y0i * ms + x0i).reshape(n),
                     (y0i * ms + x1i).reshape(n),
                     (y1i * ms + x0i).reshape(n),
                     (y1i * ms + x1i).reshape(n)])
    vals = flat_pm[idx].reshape(4, n, -1)
    top = vals[0] * (1 - wxf) + vals[1] * wxf
    bot = vals[2] * (1 - wxf) + vals[3] * wxf
    return top * (1 - wyf) + bot * wyf


def _coords(order, R=8, S=4, xs=2):
    """A slab's query coordinates as the decodes build them: LIST's
    materialised (2 fz, 2 fy, 2 fx), DISN's expanded views (fx, fy, fz)."""
    step = 1.0 / (R - 1)
    ar = torch.arange(R, dtype=torch.float32)
    ar_s = torch.arange(S, dtype=torch.float32)
    fx = ((ar_s + xs) * step - 0.5)[:, None, None].expand(S, R, R)
    fy = (ar * step - 0.5)[None, :, None].expand(S, R, R)
    fz = (ar * step - 0.5)[None, None, :].expand(S, R, R)
    if order == 'list':
        return 2.0 * fz, 2.0 * fy, 2.0 * fx
    return fx, fy, fz


def _map(C=24, dt=torch.bfloat16, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(MS * MS, C, generator=g).to(dt)


@pytest.mark.parametrize('dt', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('order', ['list', 'disn'])
def test_plain_path_is_bit_for_bit_the_inline_formula(order, dt):
    """On the CPU, ``dense_grid.percep_sample`` (through the wrapper) gives
    the inline formula's bits in both callers' coordinate orders (DISN's:
    stride-0 expanded views)."""
    torch.set_num_threads(1)
    p0, p1, p2 = _coords(order)
    if order == 'disn':
        assert 0 in p0.stride() and 0 in p2.stride()
    flat_pm, t = _map(dt=dt), torch.tensor(CAMERA)
    before = percep.launches
    got = dense_grid.percep_sample(flat_pm, t, p0, p1, p2, dt)
    want = _inline_percep(flat_pm, t, p0, p1, p2, dt)
    assert percep.launches == before
    assert got.dtype == dt and got.shape == (p0.numel(), 24)
    assert torch.equal(got, want)
    assert torch.equal(percep.percep_sample_plain(flat_pm, t, p0, p1, p2, dt),
                       want)


def test_bound_is_the_bytes_over_the_memory_rate():
    """(n, C) bf16 written and the (137^2, C) map read once, at 3.35
    TB/s: 0.647 ms at 128^3 queries and C = 512."""
    n, C = 2_097_152, 512
    nbytes = 2 * n * C + 2 * MS * MS * C
    assert percep.bound_ms(n, C) == pytest.approx(nbytes / 3.35e12 * 1e3,
                                                  rel=1e-12)
    assert round(percep.bound_ms(n, C), 3) == 0.647


def _operands():
    p0, p1, p2 = _coords('list')
    return [_map(), torch.tensor(CAMERA), p0, p1, p2, torch.bfloat16]


def _bad(i, value):
    args = _operands()
    args[i] = value
    return args


@pytest.mark.parametrize('args', [
    _bad(0, torch.zeros(136 * 136, 24, dtype=torch.bfloat16)),
    _bad(0, torch.zeros(MS * MS * 24, dtype=torch.bfloat16)),
    _bad(1, torch.zeros(3, 4)),
    _bad(2, torch.zeros(32, 8)),
    _bad(3, torch.zeros(4, 8, 8, dtype=torch.float64)),
    _bad(4, torch.zeros(4, 8, 7)),
], ids=['map_side', 'map_flat', 'camera', 'coords_2d', 'coords_f64',
        'coords_shape'])
def test_wrong_shapes_raise(args):
    """A map that is not (137^2, C), a camera that is not (4, 3) or
    coordinates that are not three (S, R, R) f32 tensors raise, on any
    device."""
    with pytest.raises(ValueError):
        percep.percep_sample(*args)


@pytest.mark.parametrize('case', ['f64', 'bf16_map_f32_out',
                                  'f32_map_bf16_out'])
def test_kernel_refuses_other_dtypes(case):
    """The kernel takes a bf16 or f32 map and writes the map's type; the
    CPU's plain path takes any of them."""
    args = _operands()
    args[0], args[5] = dict(
        f64=(args[0].double(), torch.float64),
        bf16_map_f32_out=(args[0], torch.float32),
        f32_map_bf16_out=(args[0].float(), torch.bfloat16))[case]
    with pytest.raises(TypeError):
        percep.check_operands(*args, kernel=True)
    percep.check_operands(*args, kernel=False)


@pytest.mark.parametrize('case', ['bf16', 'f32', 'f32_c_12'])
def test_kernel_takes_bf16_and_f32_maps_of_whole_vectors(case):
    """A bf16 map with C % 8 == 0 and an f32 one with C % 4 == 0, each
    writing its own type: every map the port's decodes make."""
    args = _operands()
    if case != 'bf16':
        C = 12 if case == 'f32_c_12' else 24
        args[0], args[5] = _map(C=C, dt=torch.float32), torch.float32
    percep.check_operands(*args, kernel=True)


def _shifted(C, dt, by):
    """A (137^2, C) map ``by`` elements past a fresh allocation."""
    return torch.zeros(MS * MS * C + by, dtype=dt)[by:].view(MS * MS, C)


@pytest.mark.parametrize('case', ['bf16_c_13', 'bf16_c_12', 'f32_c_6',
                                  'unaligned', 'f32_unaligned', 'strided'])
def test_kernel_refuses_rows_off_whole_16_byte_vectors(case):
    """Rows that are not whole 16-byte vectors (C % 8 != 0 in bf16, C % 4
    != 0 in f32), a map off 16-byte alignment, or a map that is not
    contiguous raise before any launch; the CPU's plain path takes them."""
    bf, f32 = torch.bfloat16, torch.float32
    flat, dt = dict(
        bf16_c_13=(_map(C=13), bf), bf16_c_12=(_map(C=12), bf),
        f32_c_6=(_map(C=6, dt=f32), f32),
        unaligned=(_shifted(24, bf, 1), bf),
        f32_unaligned=(_shifted(24, f32, 2), f32),
        strided=(_map(C=48)[:, ::2], bf))[case]
    args = _operands()
    args[0], args[5] = flat, dt
    with pytest.raises(ValueError):
        percep.check_operands(*args, kernel=True)
    percep.check_operands(*args, kernel=False)
    assert percep.percep_sample(*args).shape == (args[2].numel(),
                                                 flat.shape[1])


def test_launch_counter_and_source_are_registered():
    """``launch_counts()`` and ``reset_launch_counts()`` carry the
    sample's counter; its source is built with the others."""
    assert 'percep_sample' in KERNEL_SOURCES
    assert os.path.exists(os.path.join(build.CSRC, 'percep_sample.cu'))
    assert percep.SOURCE.endswith('csrc/percep_sample.cu')
    percep.launches = 5
    assert launch_counts()['percep_sample'] == 5
    reset_launch_counts()
    assert percep.launches == 0 and launch_counts()['percep_sample'] == 0
