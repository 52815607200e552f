"""The port's iso-band codec (``list_tpu_torch/ops/band.py``) against the
JAX package's (``list_tpu/ops/band.py``) on the same grids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from list_tpu.ops.band import band_decode as j_band_decode
from list_tpu.ops.band import band_encode as j_band_encode
from list_tpu_torch.ops.band import (BandGrid, band_decode, band_encode,
                                     band_to_numpy, fetch_grid_f32)


def _grid(kind, R=32):
    ax = np.linspace(-0.5, 0.5, R, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    bumpy = (np.sqrt(X * X + Y * Y + Z * Z) - 0.33
             + 0.03 * np.sin(9 * X) * np.cos(7 * Y + 3 * Z))
    return {'sphere': bumpy,
            'overflow': np.random.RandomState(0).randn(R, R, R),
            'no_surface': -np.abs(bumpy) - 0.01}[kind].astype(np.float32)


@pytest.mark.parametrize('kind', ['sphere', 'overflow', 'no_surface'])
@pytest.mark.parametrize('wire', ['bfloat16', 'float32'])
def test_band_encode_bit_identical(kind, wire):
    """The port's buffer, viewed as uint32 on the host, equals the JAX
    package's word for word -- sign words with bit 31 set included
    ('overflow' is white noise: count > cap) -- and both decoders rebuild
    the same grid (None on overflow)."""
    g = _grid(kind)
    ref = np.asarray(j_band_encode(jnp.asarray(
        g, jnp.bfloat16 if wire == 'bfloat16' else jnp.float32)))
    t = torch.as_tensor(g).to(torch.bfloat16 if wire == 'bfloat16'
                              else torch.float32)
    got = band_to_numpy(band_encode(t))
    assert got.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    assert (ref[:32 ** 3 // 32] >> 31).any() or kind == 'no_surface'
    a, b = band_decode(got, 32, wire), j_band_decode(ref, 32, wire)
    assert (a is None) == (b is None) == (kind == 'overflow')
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_band_grid_fetch_falls_back_on_overflow():
    """A BandGrid whose band overflowed fetches the full wire grid."""
    t = torch.as_tensor(_grid('overflow')).to(torch.bfloat16)
    got = fetch_grid_f32(BandGrid(band_encode(t), t, 32, 'bfloat16'))
    np.testing.assert_array_equal(got, t.float().numpy())
