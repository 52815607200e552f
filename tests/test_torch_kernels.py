"""The port's kernel modules against the JAX package's Pallas kernels, on
the CPU: the wrappers take their plain PyTorch versions for CPU tensors,
and the Pallas kernels run in interpret mode, as the JAX tests run them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu.ops.pallas.fused_fc0 import fused_fc0_mlp as j_mlp
from list_tpu.ops.pallas.fused_fc0 import fused_stack_head as j_head
from list_tpu.ops.pallas.stencil3d import conv3x3x3_cmajor
from list_tpu_torch.ops.cuda import fused_fc0, stencil3d


@pytest.mark.parametrize('shape', [(2, 3, 5, 4, 8, 128), (1, 1, 16, 4, 6, 128)])
def test_conv3x3x3_matches_pallas_interpret(shape):
    """K2 module: tolerance atol = rtol = 1e-4 (f32 on both sides; the sums
    of 27*Ci products are taken in another order)."""
    B, Ci, Co, D, H, W = shape
    rng = np.random.RandomState(Ci * 7 + Co)
    x = rng.randn(B, Ci, D, H, W).astype(np.float32)
    k = (rng.randn(3, 3, 3, Ci, Co) * 0.2).astype(np.float32)
    ref = np.asarray(conv3x3x3_cmajor(jnp.asarray(x), jnp.asarray(k), True))
    w = torch.as_tensor(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
    before = stencil3d.launches
    got = stencil3d.conv3x3x3(torch.as_tensor(x), w).numpy()
    assert stencil3d.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def _head_inputs(rng, n, d1, d2, Ks, coarse):
    parts = [rng.rand(n, K).astype(np.float32) for K in Ks]
    w1 = [(rng.randn(K, d1) / np.sqrt(sum(Ks))).astype(np.float32)
          for K in Ks]
    c = None if coarse is None else rng.randn(n, d1).astype(np.float32)
    percep = rng.randn(n, d1).astype(np.float32)
    q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    wxyz = rng.randn(3, d1).astype(np.float32) * 0.3
    b1 = rng.randn(d1).astype(np.float32) * 0.1
    w2 = (rng.randn(d1, d2) / np.sqrt(d1)).astype(np.float32)
    b2 = rng.randn(d2).astype(np.float32) * 0.1
    w3 = (rng.randn(d2, d2) / np.sqrt(d2)).astype(np.float32)
    b3 = rng.randn(d2).astype(np.float32) * 0.1
    w4 = (rng.randn(d2, 1) / np.sqrt(d2)).astype(np.float32)
    b4 = rng.randn(1).astype(np.float32) * 0.1
    return parts, c, percep, q, w1, wxyz, b1, w2, b2, w3, b3, w4, b4


@pytest.mark.parametrize('coarse', [None, 'f32'])
def test_fused_stack_head_plain_matches_pallas_interpret(coarse):
    """K1 module in f32 at n = 1024, d1 = 16, nine ragged parts: atol 2e-4,
    rtol 1e-3 (the dense-grid tests' tolerance for the fused head)."""
    rng = np.random.RandomState(3)
    Ks = (5, 1, 1, 8, 2, 2, 12, 4, 4)
    args = _head_inputs(rng, 1024, 16, 8, Ks, coarse)
    parts, c, percep, q, w1, *rest = args
    ref = np.asarray(j_head(
        [jnp.asarray(p) for p in parts],
        None if c is None else jnp.asarray(c), jnp.asarray(percep),
        jnp.asarray(q), [jnp.asarray(w) for w in w1],
        *[jnp.asarray(a) for a in rest], tile=256, interpret=True))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    got = fused_fc0.fused_stack_head(
        [t(p) for p in parts], None if c is None else t(c), t(percep), t(q),
        [t(w) for w in w1], *[t(a) for a in rest]).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize('channels', [(1, 4), (2, 1, 3)])
def test_fused_fc0_mlp_plain_matches_pallas_interpret(channels):
    """K4 module in f32 at n = 256, d1 = 16, t-major (7, n, C_s) stacks with
    a C = 1 scale (the TPU kernel's broadcast FMA): atol 2e-4, rtol 1e-3
    (the dense-grid tests' tolerance for the fused heads)."""
    rng = np.random.RandomState(4)
    n = 256
    _, _, percep, q, _, wxyz, b1, w2, b2, w3, b3, w4, b4 = _head_inputs(
        rng, n, 16, 8, (1,), None)
    stacks = [rng.rand(7, n, c).astype(np.float32) for c in channels]
    w1 = [(rng.randn(7 * c, 16) / np.sqrt(7 * sum(channels))).astype(
        np.float32) for c in channels]
    rest = (wxyz, b1, w2, b2, w3, b3, w4, b4)
    ref = np.asarray(j_mlp(
        [jnp.asarray(a) for a in stacks], jnp.asarray(percep),
        jnp.asarray(q), [jnp.asarray(w) for w in w1],
        *[jnp.asarray(a) for a in rest], tile=n, interpret=True))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    before = fused_fc0.mlp_launches
    got = fused_fc0.fused_fc0_mlp(
        [t(a) for a in stacks], t(percep), t(q), [t(w) for w in w1],
        *[t(a) for a in rest]).numpy()
    assert fused_fc0.mlp_launches == before  # CPU: the plain version
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
