"""The dense decode's voxel work on the CPU (``ops/cuda/voxel.py``): the
wrapper's plain version against the decode's inline arithmetic it was
moved from, bit for bit (the oracle below restates that code), for the
structured parts, the per-scale stacks and the coarse term, hoisted or per
slab, over two slab sizes and an x range; the kernel's plan table and
launch counter.  The kernel itself runs on the card
(``tests/test_torch_cuda.py -k voxel``)."""

import numpy as np
import pytest
import torch

from list_tpu_torch.ops.consts import device_const
from list_tpu_torch.ops.cuda import launch_counts, reset_launch_counts, voxel

R, DELTA, BB = 16, 0.0722, (-0.5, 0.5)
# kept groups (r, C): r = R (the identity plan, the hoisted slice) and
# r < R; coarse scales of D channels at r = 4 and 2
KEPT, COARSE, D = ((16, 5), (8, 3)), (4, 2), 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dt):
    g = torch.Generator().manual_seed(5)
    kept = [torch.randn(r, r, r, c, generator=g).to(dt) for r, c in KEPT]
    taps = [[torch.randn(r, r, r, D, generator=g).to(dt) for _ in range(7)]
            for r in COARSE]
    return kept, taps


def _inline(kept, taps, S, x_range, hoist, structured, outside):
    """The decode's voxel work as ``dense_grid_slabs`` computed it inline:
    per slab the parts (or stacks) of every group, then the coarse term."""
    x0, x1 = x_range
    dt = kept[0].dtype
    n = S * R * R
    rs = voxel.resample_axis
    zy = lambda f, r_in: voxel.zy_variants(f, r_in, R, DELTA, *BB)  # noqa
    plan_los, plan_Ls, idents = [], [], []
    for f in kept:
        key = (R, int(f.shape[0]), S, DELTA) + BB
        plan_los.append(voxel._host_x_plans(*key)[0])
        plan_Ls.append(device_const(('x_plans',) + key,
                                    lambda key=key: voxel._host_x_plans(
                                        *key)[1], 'cpu', dt))
        i0, _, w = voxel._axis_plan(R, f.shape[0], 0.0, *BB)
        idents.append(bool((w == 0).all() and (i0 == np.arange(R)).all()))
    hoist = hoist and structured
    ent = list(kept)
    if hoist:
        ent = [torch.cat([v[key] for (_, key) in voxel.TAPS[:5]], dim=-1)
               for v in (zy(f, f.shape[0]) for f in kept)]
    proj_vols = []
    for P in taps:
        r_in = P[0].shape[0]
        dz = voxel.norm_shift(DELTA, r_in)
        rz = lambda v, s: rs(v, 2, R, s, *BB)  # noqa: E731
        ry = lambda v, s: rs(v, 1, R, s, *BB)  # noqa: E731
        Tc = rz(P[0], 0.0) + rz(P[2], dz) + rz(P[1], -dz)
        U0 = ry(Tc, 0.0) + ry(rz(P[4], 0.0), dz) + ry(rz(P[3], 0.0), -dz)
        proj_vols += [U.reshape(r_in, R * R, D) for U in
                      (U0, ry(rz(P[6], 0.0), 0.0), ry(rz(P[5], 0.0), 0.0))]
    Ucat = torch.cat(proj_vols, dim=0)
    Lcat = torch.as_tensor(np.concatenate(
        [np.transpose(voxel._scan_x_plans_full(R, r, S, DELTA, *BB),
                      (0, 2, 1, 3)).reshape(R // S, S, -1) for r in COARSE],
        axis=-1)).to(dt)
    Cfull = None
    if outside:
        Cfull = voxel.mm32(Lcat[x0 // S:x1 // S].reshape(x1 - x0, -1),
                           Ucat.reshape(Ucat.shape[0], -1)).to(dt)
        Cfull = Cfull.reshape(x1 - x0, R * R, -1)
    out = []
    for k in range(x0 // S, x1 // S):
        xs, parts = k * S, []
        for gi, f in enumerate(ent):
            ch = kept[gi].shape[-1]
            L7 = plan_Ls[gi][k]
            r_max = L7.shape[-1]
            sub = voxel._dyn_slice0(f, plan_los[gi][k], r_max)
            if hoist:
                if idents[gi]:
                    A5 = voxel._dyn_slice0(f, xs, S).reshape(n, 5 * ch)
                else:
                    A5 = voxel._xlerp(L7[0], sub).to(dt).reshape(n, 5 * ch)
                Vx = sub[..., :ch]
            else:
                variants = zy(sub, f.shape[0])
                if not structured:
                    V7 = torch.stack([variants[key] for (_, key)
                                      in voxel.TAPS])
                    A = torch.bmm(L7.float(),
                                  V7.reshape(7, r_max, -1).float())
                    parts.append(A.to(dt).reshape(7, n, ch))
                    continue
                Vcat = torch.cat([variants[key] for (_, key)
                                  in voxel.TAPS[:5]], dim=-1)
                A5 = voxel._xlerp(L7[0], Vcat).to(dt).reshape(n, 5 * ch)
                Vx = variants[(0, 0)]
            parts += [A5.contiguous(),
                      voxel._xlerp(L7[5], Vx).to(dt).reshape(n, ch),
                      voxel._xlerp(L7[6], Vx).to(dt).reshape(n, ch)]
        if outside:
            coarse = Cfull[xs - x0:xs - x0 + S].reshape(n, -1)
        else:
            coarse = voxel.mm32(Lcat[k], Ucat.reshape(Ucat.shape[0], -1)
                                ).reshape(n, -1)
        out.append((parts, coarse))
    return out


# (slab, x range): the whole grid in one slab, slabs of R / 4, and the
# middle half of the rows in slabs of R / 4 (one card's block of a split
# decode)
SLABS = [(R, (0, R)), (R // 4, (0, R)), (R // 4, (R // 4, 3 * R // 4))]


@pytest.mark.parametrize('slab,x_range', SLABS,
                         ids=[f'slab{s}_x{a}-{b}' for s, (a, b) in SLABS])
@pytest.mark.parametrize('structured,hoist', [(True, False), (True, True),
                                              (False, False)],
                         ids=['parts', 'parts_hoisted', 'stacks'])
@pytest.mark.parametrize('outside', [True, False],
                         ids=['coarse_hoisted', 'coarse_per_slab'])
def test_plain_voxel_work_is_the_inline_decode_bit_for_bit(
        slab, x_range, structured, hoist, outside):
    kept, taps = _inputs(torch.bfloat16)
    want = _inline(kept, taps, slab, x_range, hoist, structured, outside)
    groups = [voxel.KeptTaps(f, R, slab, DELTA, *BB, hoist=hoist,
                             structured=structured) for f in kept]
    coarse = voxel.CoarseTerm(taps, R, slab, DELTA, *BB, x_range, outside)
    before = voxel.launches
    for k, (parts, c) in zip(range(x_range[0] // slab, x_range[1] // slab),
                             want):
        got = [p for g in groups for p in g.slab(k)]
        assert len(got) == len(parts)
        for a, b in zip(got, parts):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
        gc = coarse.slab(k)
        assert gc.dtype == c.dtype == (torch.bfloat16 if outside
                                       else torch.float32)
        assert torch.equal(gc, c)
    assert voxel.launches == before  # the plain version launches nothing


def test_kernel_plan_table_is_the_axis_plans():
    """Row 3 i + s + 1 of the kernel's table is ``_axis_plan`` of source
    resolution r_ins[i] at the shift sign s: i0 | i1 << 16 and the f32
    bits of w."""
    r_ins = (16, 8, 4)
    table = voxel._kernel_plans(R, r_ins, DELTA, *BB)
    assert table.dtype == np.int32 and table.shape == (9, R, 2)
    for i, r in enumerate(r_ins):
        for s in (-1, 0, 1):
            i0, i1, w = voxel._axis_plan(R, r, voxel.norm_shift(DELTA * s, r),
                                         *BB)
            row = table[3 * i + s + 1]
            assert (row[:, 0] & 0xffff == i0).all()
            assert (row[:, 0] >> 16 == i1).all()
            assert (row[:, 1].view(np.float32) == w).all()


def test_taps_f64_is_the_plain_resample_in_float64():
    """The card tests' float64 reference of a tap is the plain version's
    separable resample, x rows first, on float64 volumes."""
    kept, _ = _inputs(torch.float64)
    vol = kept[1]
    for sx, (sy, sz) in voxel.TAPS:
        got = voxel.tap_f64(vol, (sx, sy, sz), R, 4, 8, DELTA)
        r = vol.shape[0]
        v = vol
        for axis, s in ((0, sx), (1, sy), (2, sz)):
            v = voxel.resample_axis(v, axis, R,
                                    voxel.norm_shift(DELTA * s, r), *BB)
        torch.testing.assert_close(got, v[4:12], rtol=1e-15, atol=1e-15)


def test_kernel_volumes_must_be_bf16_on_the_card():
    """``check_volume`` refuses what the kernel does not take: a CPU
    volume, or one of another dtype or rank."""
    with pytest.raises(TypeError, match='voxel_taps kernel takes bf16'):
        voxel.check_volume(torch.zeros(4, 4, 4, 8, dtype=torch.bfloat16),
                           'a volume')
    with pytest.raises(TypeError, match='voxel_taps kernel takes bf16'):
        voxel.check_volume(torch.zeros(4, 4, 4, 8), 'a volume')


def test_voxel_launch_counter_is_kept_and_reset():
    voxel.launches = 3
    assert launch_counts()['voxel_taps'] == 3
    reset_launch_counts()
    assert launch_counts()['voxel_taps'] == 0


@pytest.mark.parametrize('r,C', [(8, 128), (4, 5)])
def test_one_projection_a_scale_is_the_per_tap_products(r, C):
    """``dense_grid_slabs`` projects a coarse scale through its seven fc_0
    tap blocks in one product (its rows (channel, tap), columns [P(0) |
    ... | P(6)]); each column block is that tap's own product, bit for
    bit."""
    g = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    V = torch.randn(r, r, r, C, generator=g).to(bf)
    W = torch.randn(7 * C, 512, generator=g)
    P7 = voxel.mm32(V, W.reshape(C, -1).to(bf)).to(bf)
    for t in range(7):
        Pt = voxel.mm32(V, W[t::7].to(bf)).to(bf)
        assert torch.equal(P7[..., t * 512:(t + 1) * 512], Pt)
