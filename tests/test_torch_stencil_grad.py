"""K2 + K3 module on the CPU: the port's differentiable ``conv3x3x3``
(``Conv3x3x3Fn``: dx through the forward convolution with flipped,
channel-transposed weights, dk through ``conv3x3x3_dk``) against
``jax.grad`` of the JAX package's Pallas kernel in interpret mode, and the
dk plain version against autograd of ``F.conv3d``.  CPU tensors take the
plain versions; no kernel launches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from list_tpu.ops.pallas.stencil3d import conv3x3x3_cmajor
from list_tpu_torch.ops.cuda import stencil3d


def _counts():
    return (stencil3d.launches, stencil3d.dx_launches, stencil3d.dk_launches)


def test_grads_match_pallas_interpret():
    """jax.grad of sum(conv3x3x3_cmajor(x, k, interpret=True) ** 2) at
    (B, Ci, D, H, W) = (1, 2, 3, 8, 128), Co = 3, against the port's
    autograd: atol = rtol = 1e-4 (f32 on both sides; dk sums 3,072 voxel
    products per tap, in another order)."""
    rng = np.random.RandomState(333)
    x = rng.randn(1, 2, 3, 8, 128).astype(np.float32)
    k = (rng.randn(3, 3, 3, 2, 3) * 0.2).astype(np.float32)

    def f(x_, k_):
        return jnp.sum(conv3x3x3_cmajor(x_, k_, True) ** 2)

    gx, gk = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))),
                      requires_grad=True)
    before = _counts()
    y = stencil3d.conv3x3x3(xt, wt)
    assert y.grad_fn is not None
    (y ** 2).sum().backward()
    assert _counts() == before
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        wt.grad.numpy(), np.transpose(np.asarray(gk), (4, 3, 0, 1, 2)),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('b,ci,co,dhw', [(2, 1, 1, (5, 7, 9)),
                                         (1, 1, 16, (4, 6, 8)),
                                         (2, 16, 16, (3, 4, 5)),
                                         (1, 16, 1, (4, 5, 6))])
def test_dk_plain_matches_conv3d_autograd(b, ci, co, dhw):
    """conv3x3x3_dk_plain(x, g) against the weight gradient of
    F.conv3d(x, w, padding=1) for upstream gradient g, at the production
    channel pairs on small volumes: atol = rtol = 1e-4 (f32)."""
    g_ = torch.Generator().manual_seed(ci * 17 + co)
    x = torch.randn(b, ci, *dhw, generator=g_)
    g = torch.randn(b, co, *dhw, generator=g_)
    w = torch.zeros(co, ci, 3, 3, 3, requires_grad=True)
    (F.conv3d(x, w, padding=1) * g).sum().backward()
    got = stencil3d.conv3x3x3_dk_plain(x, g)
    torch.testing.assert_close(got, w.grad, atol=1e-4, rtol=1e-4)


def test_fn_gradcheck_float64():
    """Conv3x3x3Fn's backward (the plain versions on the CPU) is the exact
    adjoint of its forward: torch.autograd.gradcheck in f64."""
    g_ = torch.Generator().manual_seed(5)
    x = torch.randn(1, 2, 3, 4, 5, generator=g_, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, 2, 3, 3, 3, generator=g_, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(stencil3d.conv3x3x3, (x, w))


@pytest.mark.parametrize('x_grad', [False, True])
def test_dx_only_when_the_input_needs_it(monkeypatch, x_grad):
    """The backward runs the dx convolution only when the input needs a
    gradient (the first convolution's input, the occupancy grid, does
    not); dk always."""
    calls = []
    real = stencil3d.conv3x3x3_plain
    monkeypatch.setattr(stencil3d, 'conv3x3x3_plain',
                        lambda x, w: calls.append(1) or real(x, w))
    x = torch.randn(1, 1, 4, 4, 4, requires_grad=x_grad)
    w = torch.randn(1, 1, 3, 3, 3, requires_grad=True)
    stencil3d.conv3x3x3(x, w).sum().backward()
    assert len(calls) == 1 + int(x_grad)
    assert w.grad is not None and (x.grad is not None) == x_grad
