"""bench_torch.py, the port's benchmark, on the CPU: its counts against
bench.py's recorded ones, and one whole run at a tiny size (every key
present, the device-only keys "not measured", every timing finite)."""

import json
import math
import os

import pytest
import torch

import bench
import bench_torch
from list_tpu_torch.device import peak_rates
from list_tpu_torch.models.list_model import DEFAULT_IM_ENC_LAYERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# vox_res 16, 2 items (a training BatchNorm needs more than one), 256
# queries, 1 timed step, 2 meshes a trial, the fine grid at 32^3; the
# tests' tiny widths (tests/test_torch_model.py)
TINY = bench_torch.Sizes(
    vox_res=16, r_hi=32, img_res=32, train_batch=2, train_queries=256,
    train_steps=1, train_multi_calls=1, trials=1, meshes=2, grid_meshes=1,
    serial=1, batch_images=1, batch_reps=1, reps=1, hi_reps=1, hi_meshes=1,
    chunk=1024, anchor_chunks=2, eval_points=1000,
    model=(('point_feat', [128, 8, 8, 3]), ('point_degree', [2, 2, 4]),
           ('im_enc_layers', [1, 1, 1, 1, 2, 4, 4, 4])))

KEYS = (
    'device', 'device_count', 'card', 'peak_bf16_tflops', 'hbm_tbs',
    'train_step_s', 'train_step_s_all', 'train_step_s_k2',
    'train_first_step_s', 'train_losses', 'train_batch',
    'train_steps_per_sec', 'train_qps', 'train_model_tflop',
    'train_eff_tflops', 'train_mfu_pct', 'train_gather_gb',
    'train_hbm_bound_s', 'train_peak_gb', 'train_launches',
    'n_queries', 'fetch_mode', 'sec_per_mesh_128', 'sec_per_mesh_128_trials',
    'sec_per_mesh_128_gridwire', 'sec_per_mesh_128_serial', 'first_mesh_s',
    'infer_peak_gb', 'mesh_launches', 'sec_per_mesh_128_batched4',
    'encode_s', 'encode_s_device', 'decode_s', 'decode_s_device', 'fetch_s',
    'wire_mbps', 'band_wire_kb', 'band_fetch_s', 'band_host_decode_s',
    'decode_eff_tflops', 'decode_mfu_pct', 'sec_per_mesh_128_device',
    'qps_device', 'decode_s_256', 'sec_per_mesh_256', 'qps_256',
    'band_overflow_256', 'launches_256', 'chunked_qps_measured',
    'chunked_launches', 'speedup_vs_chunked_on_chip',
    'speedup_256_vs_chunked', 'eval_s_per_shape', 'eval_mc_s')
# TPU-era and reference-GPU anchors of bench.py that the port does not state
DROPPED = ('vs_baseline', 'vs_ref_fp32_ceiling', 'train_vs_baseline',
           'train_vs_ref_fp32_ceiling', 'relay_rtt_s', 'train_compile_s',
           'compile_s')


def _recorded():
    with open(os.path.join(REPO, 'BENCH_r05.json')) as f:
        return json.load(f)['parsed']['extras']


def test_counts_match_bench_py():
    """The shape counts give bench.py's recorded numbers at its batch 4
    (BENCH_r05.json) and the reference's batch 8, and FLOP_PER_QUERY is
    bench.py's constant."""
    rec = _recorded()
    assert rec['train_batch'] == 4
    assert round(bench_torch.train_model_tflop(4), 2) \
        == rec['train_model_tflop'] == 2.51
    assert round(bench_torch.train_gather_gb(4), 1) \
        == rec['train_gather_gb'] == 16.3
    assert round(bench_torch.train_model_tflop(8), 2) == 5.02
    assert round(bench_torch.train_gather_gb(8), 1) == 32.5
    assert bench_torch.FLOP_PER_QUERY == bench.FLOP_PER_QUERY == 4090368
    assert bench_torch.decoder_flop_per_query() == bench.FLOP_PER_QUERY


def test_launch_counts_follow_the_code():
    """The launches a path must give: K2 5 a mesh, 14 a remat'd step (of
    which dx 4) with K3 5; one perceptual sample a decode's slab; at 128^3
    the voxel encoder's bn_0, bn_1, bn_3 and bn_4 on the BatchNorm
    kernels, at any batch (bn_5 has 64 channels), the training forward's
    at one channel only; none on the CPU."""
    assert bench_torch.full_res_convs() == 5
    assert bench_torch.routed_norms(DEFAULT_IM_ENC_LAYERS, 8, 128) \
        == bench_torch.routed_norms(DEFAULT_IM_ENC_LAYERS, 1, 128) \
        == [1, 1, 16, 32]
    assert bench_torch.routed_norms(DEFAULT_IM_ENC_LAYERS, 2, 32) == []
    assert bench_torch.step_launches(True, (1, 1, 1, 1, 16), True, 8,
                                     128) == dict(
        conv3x3x3=14, conv3x3x3_dx=4, conv3x3x3_dk=5, fused_stack_head=0,
        fused_fc0_mlp=0, batch_norm=4, batch_norm_bwd=3, percep_sample=0)
    assert bench_torch.step_launches(True, DEFAULT_IM_ENC_LAYERS, True, 8,
                                     128)['batch_norm_bwd'] == 4
    assert bench_torch.decode_launches(True, 256, 8, 2) == dict(
        conv3x3x3=0, conv3x3x3_dx=0, conv3x3x3_dk=0, fused_stack_head=32,
        fused_fc0_mlp=0, batch_norm=0, batch_norm_bwd=0, percep_sample=32)
    assert set(bench_torch.decode_launches(False, 128, 128, 2,
                                           k2=5, bn=4).values()) == {0}


def test_rates_are_known_only_for_the_h100():
    """The data-sheet rates are the H100 SXM's; another card raises."""
    assert peak_rates('NVIDIA H100 80GB HBM3') == dict(
        bf16_tflops=989.0, f32_tflops=67.0, mem_gbs=3350.0)
    with pytest.raises(ValueError, match='no data-sheet rates'):
        peak_rates('NVIDIA A100-SXM4-80GB')


def test_cuda_run_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='cuda'):
        bench_torch.run('cuda', 0, TINY)


@pytest.fixture(scope='module')
def line():
    # one intra-op thread: the run is many small ops, and beside the
    # other test workers more threads only contend for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return bench_torch.run(device='cpu', seed=0, sizes=TINY)
    finally:
        torch.set_num_threads(threads)


def test_cpu_run_gives_every_key(line):
    """run(device='cpu') returns the result line with every key; the
    headline is 16^3 over the median trial."""
    assert line['metric'] == 'sdf_queries_per_sec'
    assert line['unit'] == 'queries/s'
    x = line['extras']
    assert not [k for k in KEYS if k not in x]
    assert not [k for k in DROPPED if k in x or k in line]
    assert line['value'] == TINY.vox_res ** 3 / x['sec_per_mesh_128']
    assert x['device'] == 'cpu' and x['train_batch'] == 2
    assert len(x['train_step_s_all']) == TINY.train_steps
    assert len(x['sec_per_mesh_128_trials']) == TINY.trials
    assert all(math.isfinite(v) for v in x['train_losses'].values())
    assert x['eval_iou'] > 0.5
    assert x['band_overflow_256'] in (0, 1)


def test_cpu_run_measures_no_device_metric(line):
    """Each device-only key is "not measured" on the CPU, every other
    number is finite, and no kernel was launched."""
    x = line['extras']
    for k in bench_torch.DEVICE_ONLY:
        assert x[k] == 'not measured', k
    nums = [(k, v) for k, v in x.items() if k not in bench_torch.DEVICE_ONLY
            and isinstance(v, (int, float)) and not isinstance(v, bool)]
    assert len(nums) > 25
    assert all(math.isfinite(v) for _, v in nums), nums
    assert all(v > 0 for k, v in nums if k.endswith('_s')), nums
    for k in ('train_launches', 'mesh_launches', 'launches_256',
              'chunked_launches'):
        assert set(x[k].values()) == {0}, k
    json.dumps(line)
