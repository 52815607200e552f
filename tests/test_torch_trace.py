"""The port's spans and counters (``list_tpu_torch/utils/spans.py``) on the
CPU: nothing recorded while recording is off, the newest recorded stretch
kept, and the spans of a training step and of a mesh request, at tiny
sizes."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from list_tpu_torch.config import default_config
from list_tpu_torch.data import SyntheticSDFDataset, collate
from list_tpu_torch.models import LIST, CoarseNet
from list_tpu_torch.ops.band import BandGrid, band_encode, fetch_grid_f32
from list_tpu_torch.train.executors import CoarseNetExecutor, LISTExecutor
from list_tpu_torch.utils import spans
from list_tpu_torch.utils.spans import count, recording, snapshot, span

CFG = dict(vox_res=16, img_res=32, sample_point_density=128,
           coarse_point_density=500, train_batch_size=2,
           point_feat=[128, 8, 8, 3], point_degree=[2, 2, 4],
           im_enc_layers=[1, 1, 1, 1, 2, 4, 4, 4], sdf_scale=10.0,
           test_pointnum=1024, remat=1, train_query_chunks=2)
TINY = dict(vox_res=16, point_feat=(128, 8, 8, 3), point_degree=(2, 2, 4),
            im_enc_layers=(1, 1, 1, 1, 2, 4, 4, 4), h_dim=8, support=2)


class _Event:
    """A stand-in for a CUDA event on the CPU: the host clock."""
    made = 0
    synced = 0

    def __init__(self):
        _Event.made += 1
        self.t = time.perf_counter()

    def synchronize(self):
        _Event.synced += 1

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def fake_events(monkeypatch):
    _Event.made = _Event.synced = 0
    monkeypatch.setattr(spans, 'device_event', lambda device: _Event())
    return _Event


def _names(snap):
    return [s['name'] for s in snap['spans']]


def test_off_records_nothing(fake_events, monkeypatch):
    """Off, a span is the shared no-op (no record_function, no event) and
    a count adds nothing; the store keeps the last recorded stretch."""
    with recording(True):
        with span('kept'):
            pass
    monkeypatch.setattr(spans._profiler, 'record_function', None)
    with recording(False):
        with span('dropped', device='cuda') as s:
            assert s is None
        count('dropped')
        assert span('a', 'cuda') is span('b')
    assert fake_events.made == 0
    snap = snapshot()
    assert _names(snap) == ['kept'] and snap['counters'] == {}


def test_recorded_under_the_profiler_and_when_forced(fake_events):
    """A span under ``torch.profiler`` is on the profiler's timeline; its
    device time waits for ``snapshot``."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with span('traced', device='cuda'):
            time.sleep(0.002)
    assert 'traced' in {e.name for e in prof.events()}
    assert fake_events.made == 2 and fake_events.synced == 0
    (row,) = snapshot()['spans']
    assert row['name'] == 'traced' and fake_events.synced == 1
    assert 2.0 <= row['host_ms'] <= row['device_ms']
    with recording(True):
        with span('forced') as s:
            assert s is not None
    assert _names(snapshot()) == ['forced']


def test_newest_stretch_parents_and_ids():
    """Each stretch starts a new store; a child takes the enclosing span's
    id, or an explicit parent's from another thread."""
    with recording(True):
        with span('old'):
            pass
        count('old')
    with recording(True):
        with span('root') as root:
            with span('child'):
                pass
        with ThreadPoolExecutor(1) as pool:
            pool.submit(lambda: span('remote', parent=root).__enter__()
                        .__exit__(None, None, None)).result()
        with span('other'):
            pass
        count('n', 2)
    snap = snapshot()
    rows = {s['name']: s for s in snap['spans']}
    assert set(rows) == {'root', 'child', 'remote', 'other'}
    assert snap['counters'] == {'n': 2}
    r = rows['root']
    assert r['parent'] is None and rows['other']['id'] != r['id']
    for name in ('child', 'remote'):
        assert rows[name]['id'] == r['id']
        assert rows[name]['parent'] == r['serial']


def test_counts_and_spans_from_many_threads():
    """Counts and spans from more threads than cores, switching often:
    none is lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording(True):
            def work():
                for _ in range(200):
                    count('hits')
                    with span('w'):
                        pass
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = snapshot()
    assert snap['counters'] == {'hits': 3200}
    assert len(snap['spans']) == 3200


def _children(snap, parent):
    return sorted(s['name'] for s in snap['spans']
                  if s['parent'] == parent['serial'])


@pytest.fixture(scope='module')
def list_executor():
    torch.manual_seed(0)
    return LISTExecutor(default_config(**CFG),
                        LIST(**TINY, remat=True, train_query_chunks=2),
                        device='cpu')


@pytest.mark.parametrize('kind', ['LIST', 'CoarseNet'])
def test_train_step_spans(kind, list_executor):
    """One step: ``step`` and its children ``step.batch``,
    ``step.forward``, ``step.backward`` (no ``step.allreduce`` without a
    process group), all of one id."""
    if kind == 'LIST':
        ex = list_executor
        ds = SyntheticSDFDataset(ex.config, 'train', n_shapes=2)
        batch = collate([ds[0], ds[1]])
    else:
        torch.manual_seed(0)
        ex = CoarseNetExecutor(default_config(**CFG),
                               CoarseNet(point_feat=(128, 8, 8, 3),
                                         point_degree=(2, 2, 4)),
                               device='cpu')
        rng = np.random.RandomState(3)
        batch = {'rgb_image': rng.rand(2, 32, 32, 3).astype(np.float32),
                 'pc': (rng.rand(2, 300, 3) - 0.5).astype(np.float32)}
    with recording(True):
        ex.train(batch)
    snap = snapshot()
    (step,) = [s for s in snap['spans'] if s['name'] == 'step']
    assert step['parent'] is None
    assert _children(snap, step) == ['step.backward', 'step.batch',
                                     'step.forward']
    assert {s['id'] for s in snap['spans']} == {step['id']}
    assert all(s['device_ms'] is None for s in snap['spans'])


def test_request_spans_share_one_id(list_executor):
    """A ``predict_grid(device_out=True)`` fetched on another thread:
    ``request.launch`` and, under its id, ``request.upload``,
    ``request.encode``, the
    decode's ``decode.voxel`` and ``decode.percep``, ``request.finish``
    and ``request.fetch`` (the launch its parent); one band fetch, no
    fallback; a mesh is ``mesh.generate``."""
    img = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
    ex = list_executor
    with recording(True):
        res = ex.predict_grid(img, device_out=True, fetch_mode='band')
        with ThreadPoolExecutor(1) as pool:
            grid = pool.submit(fetch_grid_f32, res).result()
        ex.test({'rgb_image': img})
    np.testing.assert_array_equal(
        grid, ex.predict_grid(img, fetch_mode='band'))
    snap = snapshot()
    launch = [s for s in snap['spans'] if s['name'] == 'request.launch']
    first = launch[0]
    mine = [s for s in snap['spans'] if s['id'] == first['id']]
    names = {s['name'] for s in mine}
    assert names == {'request.launch', 'request.upload', 'request.encode',
                     'decode.voxel', 'decode.percep', 'request.finish',
                     'request.fetch'}
    (fetch,) = [s for s in mine if s['name'] == 'request.fetch']
    assert fetch['parent'] == first['serial']
    assert sum(s['name'] == 'decode.voxel' for s in mine) == 2
    assert 'mesh.generate' in _names(snap) and len(launch) == 2
    assert snap['counters'] == {'band.fetches': 2}


def test_band_overflow_counts_a_fallback():
    """A band that overflowed takes the full-grid fetch:
    ``band.fallbacks`` counts it beside ``band.fetches``."""
    t = torch.as_tensor(np.random.RandomState(0).randn(16, 16, 16)
                        ).to(torch.bfloat16)
    with recording(True):
        got = fetch_grid_f32(BandGrid(band_encode(t), t, 16, 'bfloat16'))
    np.testing.assert_array_equal(got, t.float().numpy())
    assert snapshot()['counters'] == {'band.fetches': 1,
                                      'band.fallbacks': 1}
