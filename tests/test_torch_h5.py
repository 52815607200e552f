"""The port's HDF5 files (``list_tpu_torch/utils/h5.py``) against h5py:
what the port writes, h5py reads back exactly (dtype, shape, compression,
values); what h5py writes by default, contiguous or gzip-chunked in any
chunk shape, the port reads exactly, and it refuses what it does not
read; appending works both ways."""

import numpy as np
import pytest

import h5py
from list_tpu_torch.utils import h5

RNG = np.random.RandomState(0)
ARRAYS = {
    'grid_points': (RNG.rand(1200, 3), None),
    'query_points_sigma_0.003': (RNG.rand(1200, 4), 'gzip'),
    'occ': ((RNG.rand(4096) > 0.7).astype(np.uint8), 'gzip'),
    'f32': (RNG.rand(7, 5, 3).astype(np.float32), 'gzip'),
    'i64': (RNG.randint(-5, 5, 11).astype(np.int64), 'gzip'),
    'i16': (RNG.randint(-5, 5, (3, 4)).astype(np.int16), None),
    'scalar': (np.float64(3.5), None),
    'empty': (np.zeros((0, 3)), None),
}


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', sorted(ARRAYS))
def test_h5py_reads_what_the_port_writes(tmp_path, name):
    path = str(tmp_path / 'port.h5')
    with h5.File(path, 'w') as f:
        for k, (a, comp) in ARRAYS.items():
            f.create_dataset(k, data=a, compression=comp)
    a, comp = ARRAYS[name]
    with h5py.File(path, 'r') as f:
        assert sorted(f.keys()) == sorted(ARRAYS)
        _same(f[name][()], np.asarray(a))
        assert f[name].compression == comp


H5PY_CASES = {
    'default gzip': dict(compression='gzip'),
    'contiguous': dict(),
    'gzip, ragged chunks': dict(compression='gzip', chunks=(128, 2)),
    'gzip 9, a chunk B-tree of several levels': dict(
        compression='gzip', compression_opts=9, chunks=(3, 1)),
}


@pytest.mark.parametrize('case', sorted(H5PY_CASES))
def test_the_port_reads_what_h5py_writes(tmp_path, case):
    path = str(tmp_path / 'h5py.h5')
    a = RNG.rand(999, 3).astype(np.float32)
    with h5py.File(path, 'w') as f:
        f.create_dataset('a', data=a, **H5PY_CASES[case])
        f.create_dataset('b', data=np.arange(5, dtype=np.int32))
        f.attrs['note'] = 1
    with h5.File(path, 'r') as f:
        assert f.keys() == ['a', 'b'] and 'a' in f and 'c' not in f
        _same(f['a'][:], a)
        _same(np.asarray(f['b']), np.arange(5, dtype=np.int32))
        assert f['a'].compression == H5PY_CASES[case].get('compression')
        assert f['a'].shape == a.shape


@pytest.mark.parametrize('extra', ['shuffle', 'fletcher32', 'group'])
def test_the_port_refuses_what_it_does_not_read(tmp_path, extra):
    path = str(tmp_path / 'h5py.h5')
    with h5py.File(path, 'w') as f:
        if extra == 'group':
            f.create_group('sub')
        else:
            f.create_dataset('a', data=np.zeros((10, 3)), chunks=(5, 3),
                             **{extra: True})
    with pytest.raises(NotImplementedError):
        h5.File(path, 'r')


def test_many_datasets_both_ways(tmp_path):
    """40 datasets: several symbol-table nodes under the root's B-tree."""
    names = [f'res_{i}_points_{i * 7}' for i in range(40)]
    ours, theirs = str(tmp_path / 'port.h5'), str(tmp_path / 'h5py.h5')
    with h5.File(ours, 'w') as f, h5py.File(theirs, 'w') as g:
        for i, n in enumerate(names):
            f.create_dataset(n, data=np.arange(i + 1.0), compression='gzip')
            g.create_dataset(n, data=np.arange(i + 1.0), compression='gzip')
    with h5py.File(ours, 'r') as f, h5.File(theirs, 'r') as g:
        assert sorted(f.keys()) == sorted(names) == g.keys()
        for i, n in enumerate(names):
            _same(f[n][:], np.arange(i + 1.0))
            _same(g[n][:], np.arange(i + 1.0))


def test_append_both_ways(tmp_path):
    """'a' on an h5py file keeps its datasets and adds one; h5py's 'a' on
    the port's file likewise; a name that exists is refused."""
    path = str(tmp_path / 'occ.h5')
    occ = (RNG.rand(16 ** 3) > 0.5).astype(np.uint8)
    with h5py.File(path, 'w') as f:
        f.create_dataset('res_16_points_500', data=occ, compression='gzip')
    with h5.File(path, 'a') as f:
        assert 'res_16_points_500' in f.keys()
        f.create_dataset('res_32_points_500', data=occ[::-1],
                         compression='gzip')
        with pytest.raises(ValueError):
            f.create_dataset('res_16_points_500', data=occ)
    with h5py.File(path, 'a') as f:
        _same(f['res_16_points_500'][:], occ)
        _same(f['res_32_points_500'][:], occ[::-1])
        f.create_dataset('res_64_points_500', data=occ[:7])
    with h5.File(path, 'r') as f:
        assert f.keys() == ['res_16_points_500', 'res_32_points_500',
                            'res_64_points_500']
        _same(f['res_64_points_500'][:], occ[:7])
        with pytest.raises(ValueError):
            f.create_dataset('x', data=occ)
