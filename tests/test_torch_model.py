"""The port's LIST encode, general decoder and dense-grid decode against
the JAX package on the tiny LIST (R=16), in f32 on the CPU; weights reach
the port through ``bridge.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu.models import LIST as JLIST
from list_tpu.ops.dense_grid import dense_grid_sdf as j_dense
from list_tpu_torch.bridge import load_flax_variables
from list_tpu_torch.models import LIST
from list_tpu_torch.ops import consts
from list_tpu_torch.ops.cuda import fused_fc0
from list_tpu_torch.ops.dense_grid import dense_grid_sdf
from tools.torch_decode_probe import numpy_uploads

R = 16
TINY = dict(vox_res=R, point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4),
            im_enc_layers=(1, 1, 1, 1, 2, 4, 4, 4), h_dim=8, support=2)


@pytest.fixture(scope='module')
def pair():
    jm = JLIST(**TINY)
    img = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(img),
                         jnp.zeros((1, 8, 3)))
    jenc = jm.apply(v, jnp.asarray(img), method=jm.encode)
    tm = LIST(**TINY)
    load_flax_variables(tm, jax.tree.map(np.asarray, v))
    tm.eval()
    with torch.no_grad():
        tenc = tm.encode(torch.as_tensor(img))
    return jm, v, jenc, tm, tenc


def _entries(enc):
    out = {k: enc[k] for k in ('pc', 'trans_mat', 'occ_in', 'occ_pred')}
    out.update({f'vox_feat{i}': f for i, f in enumerate(enc['vox_feat'])})
    out.update({f'feat_l2_{i}': f for i, f in enumerate(enc['feat_l2'])})
    return out


ENTRIES = (['pc', 'trans_mat', 'occ_in', 'occ_pred']
           + [f'vox_feat{i}' for i in range(5)]
           + [f'feat_l2_{i}' for i in range(5)])


@pytest.mark.parametrize('name', ENTRIES)
def test_encode_entry_matches(pair, name):
    """Every entry of LIST.encode in eval mode, f32: atol = rtol = 1e-4
    (convolution and matmul sums in another order)."""
    _, _, jenc, _, tenc = pair
    a = np.asarray(_entries(jenc)[name])
    b = _entries(tenc)[name].numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)


def test_decode_sdf_general_matches(pair):
    """The general gather decoder (the executor's chunked fallback): same
    random queries, atol 2e-4 / rtol 1e-3."""
    jm, v, jenc, tm, tenc = pair
    q = np.random.RandomState(5).uniform(-0.55, 0.55, (1, 300, 3)).astype(
        np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(q), jenc,
                              method=jm.decode_sdf))
    with torch.no_grad():
        got = tm.decode_sdf(torch.as_tensor(q), tenc).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


MODES = {'none': {}, 'inscan': dict(coarse_proj=8, coarse_outside=False),
         'hoisted': dict(coarse_proj=8, coarse_outside=True)}


@pytest.mark.parametrize('slab', [4, 16])
@pytest.mark.parametrize('mode', list(MODES))
def test_dense_grid_matches_fused_head_interpret(pair, mode, slab):
    """dense_grid_sdf against the JAX package's use_pallas=2 decode with
    the Pallas head in interpret mode, f32, in each coarse mode (none,
    in-scan f32 coarse, hoisted coarse): atol 2e-4, rtol 1e-3.  slab=4
    takes the hoisted z/y variants, slab=16 (the whole grid, as the
    executor runs it) the per-slab ones."""
    _, v, jenc, tm, tenc = pair
    kw = MODES[mode]
    ref = np.asarray(j_dense(
        v['params']['sdf_decoder'], jenc['vox_feat'], jenc['feat_l2'],
        jenc['trans_mat'], R, slab=slab, compute_dtype=jnp.float32,
        use_pallas=2, pallas_interpret=True, **kw))
    got = dense_grid_sdf(tm.sdf_decoder, tenc['vox_feat'], tenc['feat_l2'],
                         tenc['trans_mat'], R, slab=slab,
                         compute_dtype=torch.float32, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize('slab', [4, 16])
@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('use_pallas', [1, 0])
def test_dense_grid_other_heads_match(pair, use_pallas, mode, slab):
    """dense_grid_sdf with use_pallas=1 (the per-scale t-major stacks, the
    coarse term folded into the perceptual one, K4's plain version on the
    CPU) and use_pallas=0 (the XLA head, fused_stack_head_plain, over the
    structured parts) against the JAX package's same mode with the Pallas
    head in interpret mode, f32, in each coarse mode: atol 2e-4,
    rtol 1e-3."""
    _, v, jenc, tm, tenc = pair
    kw = MODES[mode]
    ref = np.asarray(j_dense(
        v['params']['sdf_decoder'], jenc['vox_feat'], jenc['feat_l2'],
        jenc['trans_mat'], R, slab=slab, compute_dtype=jnp.float32,
        use_pallas=use_pallas, pallas_interpret=True, **kw))
    got = dense_grid_sdf(tm.sdf_decoder, tenc['vox_feat'], tenc['feat_l2'],
                         tenc['trans_mat'], R, slab=slab,
                         compute_dtype=torch.float32, use_pallas=use_pallas,
                         **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_dense_grid_rejects_an_unknown_head(pair):
    """A use_pallas outside 0/1/2 raises instead of picking a head."""
    _, _, _, tm, tenc = pair
    with pytest.raises(ValueError, match='use_pallas'):
        dense_grid_sdf(tm.sdf_decoder, tenc['vox_feat'], tenc['feat_l2'],
                       tenc['trans_mat'], R, use_pallas=-1)


def test_dense_grid_coarse_term_is_used(pair, monkeypatch):
    """The coarse modes really feed a coarse term to the head (and the
    no-coarse mode does not)."""
    _, _, _, tm, tenc = pair
    seen = []
    real = fused_fc0.fused_stack_head

    def spy(parts, coarse, *a):
        seen.append(None if coarse is None else coarse.dtype)
        return real(parts, coarse, *a)

    import list_tpu_torch.ops.dense_grid as dg
    monkeypatch.setattr(dg, 'fused_stack_head', spy)
    for kw in MODES.values():
        dense_grid_sdf(tm.sdf_decoder, tenc['vox_feat'], tenc['feat_l2'],
                       tenc['trans_mat'], R, compute_dtype=torch.bfloat16,
                       **kw)
    assert seen == [None, torch.float32, torch.bfloat16]


def test_dense_grid_fine_grid_matches_the_xla_head(pair):
    """The grid at twice the features' resolution (R = 32 from the 16^3
    features), as the executor decodes 256^3 from 128^3 features: slab 8,
    no hoisted z/y variants and the coarse term inside the scan (their
    automatic settings above R = 128), with scales of 8^3 and below
    projected (coarse_proj 8, so that the 16^3 scale is kept as 128^3 is
    at R = 256).  The port's use_pallas=2 (K1's plain version on the CPU)
    against the JAX package's XLA head (use_pallas=False), f32: atol 2e-4,
    rtol 1e-3."""
    _, v, jenc, tm, tenc = pair
    kw = dict(slab=8, coarse_proj=8, coarse_outside=False,
              hoist_variants=False)
    ref = np.asarray(j_dense(
        v['params']['sdf_decoder'], jenc['vox_feat'], jenc['feat_l2'],
        jenc['trans_mat'], 2 * R, compute_dtype=jnp.float32,
        use_pallas=False, **kw))
    got = dense_grid_sdf(tm.sdf_decoder, tenc['vox_feat'], tenc['feat_l2'],
                         tenc['trans_mat'], 2 * R,
                         compute_dtype=torch.float32, use_pallas=2,
                         **kw).numpy()
    assert got.shape == (2 * R,) * 3
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


# ---- constants kept on the device ----------------------------------------------

UPLOAD_CASES = {
    'R16': dict(vox_res=R, slab=4, coarse_proj=8, coarse_outside=True),
    'R32-coarse-projected': dict(vox_res=2 * R, slab=8, coarse_proj=8,
                                 coarse_outside=False, hoist_variants=False),
}


@pytest.fixture
def one_thread():
    """torch on one thread for the test (tiny ops beside the other test
    workers), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('use_pallas', [0, 1, 2])
@pytest.mark.parametrize('case', list(UPLOAD_CASES))
def test_dense_grid_second_call_uploads_nothing(pair, one_thread, case,
                                                use_pallas):
    """After one call on a cleared cache, dense_grid_sdf makes no tensor
    of a host array (its plans, indices and resize matrices come from
    ``ops/consts.py``), and its grid is bit-identical to that first
    call's: R 16 (hoisted variants and coarse term) and R 32 from the
    16^3 features (scales of 8^3 and below projected, the coarse term
    inside the slab loop), under each head."""
    _, _, _, tm, tenc = pair
    kw = dict(UPLOAD_CASES[case])
    res = kw.pop('vox_res')

    def call():
        return dense_grid_sdf(tm.sdf_decoder, tenc['vox_feat'],
                              tenc['feat_l2'], tenc['trans_mat'], res,
                              compute_dtype=torch.float32,
                              use_pallas=use_pallas, **kw)

    consts.CONSTS.clear()
    first = call()
    with numpy_uploads() as uploads:
        second = call()
    assert uploads == [] and torch.equal(second, first)


def test_constants_key_on_the_card_index_and_the_dtype(monkeypatch):
    """``cuda`` resolves to the current card's index (so ``cuda`` and
    ``cuda:0`` share an entry and ``cuda:1`` does not); one key in two
    dtypes makes two entries, a repeat call returns the same tensor
    without building it again, and the cache drops its least recently used
    entry past its bound."""
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert consts.resolve_device('cuda') == consts.resolve_device('cuda:0') \
        == torch.device('cuda', 0) != consts.resolve_device('cuda:1')
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 1)
    assert consts.resolve_device('cuda') == torch.device('cuda', 1)
    assert consts.resolve_device('cpu') == torch.device('cpu')
    cache = consts.ConstCache(max_entries=2)
    made = []

    def make(key):
        made.append(key)
        return np.arange(4, dtype=np.float32) + len(made)

    a = cache.get('a', lambda: make('a'), 'cpu', torch.float32)
    a64 = cache.get('a', lambda: make('a'), 'cpu', torch.float64)
    assert (a.dtype, a64.dtype, made) == (torch.float32, torch.float64,
                                          ['a', 'a'])
    assert cache.get('a', lambda: make('a'), 'cpu', torch.float32) is a
    cache.get('b', lambda: make('b'), 'cpu')
    assert len(cache) == 2 and made == ['a', 'a', 'b']
    assert cache.get('a', lambda: make('a'), 'cpu', torch.float32) is a
    cache.get('a', lambda: make('a'), 'cpu', torch.float64)
    assert made == ['a', 'a', 'b', 'a']  # the f64 entry had been dropped
