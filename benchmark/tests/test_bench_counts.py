"""The operation and byte counts against values worked by hand for the
published shapes."""

import json
import os

import pytest

from benchmark import counts, peaks
from benchmark.harness import ROOT

CFG = json.load(open(os.path.join(ROOT, 'benchmark', 'configs',
                                  'list_stage2.json')))
H100 = peaks.PEAKS['NVIDIA H100 80GB HBM3']


def test_resnet18_at_224_with_a_stride_one_first_conv():
    conv1 = 2 * 224 * 224 * 3 * 64 * 49            # 944,111,616
    l1 = 4 * 2 * 112 * 112 * 64 * 64 * 9           # 4 convs at 112^2
    l2 = (2 * 56 * 56 * 64 * 128 * 9 + 3 * 2 * 56 * 56 * 128 * 128 * 9
          + 2 * 56 * 56 * 64 * 128)
    l3 = (2 * 28 * 28 * 128 * 256 * 9 + 3 * 2 * 28 * 28 * 256 * 256 * 9
          + 2 * 28 * 28 * 128 * 256)
    l4 = (2 * 14 * 14 * 256 * 512 * 9 + 3 * 2 * 14 * 14 * 512 * 512 * 9
          + 2 * 14 * 14 * 256 * 512)
    fc = 2 * (512 * 1000 + 1000 * 128)
    assert counts.resnet18_flops(224) == conv1 + l1 + l2 + l3 + l4 + fc


def test_decoder_width_and_flops_a_query():
    assert counts.decoder_in_dim(CFG['im_enc_layers']) == 3610
    assert counts.decoder_flop_per_query(3610, 256) == 2 * (
        3610 * 512 + 512 * 256 + 256 * 256 + 256) == 4_090_368


def test_voxel_encoder_flops():
    R = 128
    want = 3 * 2 * R ** 3 * 27                         # 1 -> 1, three times
    for ci, co, r in ((1, 16, 128), (16, 32, 64), (32, 64, 32),
                      (64, 128, 16), (128, 128, 8)):
        want += 2 * r ** 3 * 27 * (ci * co + co * co)
    assert counts.vox_encoder_flops(CFG['im_enc_layers'], R) == want


def test_treegcn_flops_of_the_last_layer():
    # one layer: depth 0, 1 node, 128 -> 3 features, degree 4
    f = 2 * (1 * 128 * 3) + 2 * 128 * 4 * 128 \
        + 2 * 4 * (128 * 128 * 10 + 128 * 10 * 3)
    assert counts.treegcn_flops([128, 3], [4]) == f


def test_train_step_and_mesh_flops():
    q = 14746 + 14418 + 3277
    assert counts.train_queries(CFG) == q == 32441
    enc = counts.list_encode_flops(CFG)
    assert counts.list_train_step_flops(CFG) == 3 * 8 * (enc + q * 4_090_368)
    assert counts.mesh_flops(CFG, 128) == enc + 128 ** 3 * 4_090_368


def test_k1_bound_at_128_cubed():
    # fc_0 over 7 x (1 + 16 + 32 + 64) = 791 rows, then 512-256-256-1:
    # operations bound, 2 x 2^21 x 601,856 MACs at 989 TFLOP/s
    k = 791
    macs = 2 ** 21 * (k * 512 + 512 * 256 + 256 * 256 + 256)
    assert counts.k1_bound_s(CFG, 2 ** 21, H100) == pytest.approx(
        2 * macs / 989e12, rel=1e-12)
    assert counts.k1_bound_s(CFG, 2 ** 21, H100) * 1e3 == pytest.approx(
        2.5524, abs=1e-4)


def test_stencil_bound_of_a_train_step():
    calls = counts.stencil_calls(CFG)
    pairs = sorted((ci, co) for ci, co, _ in calls)
    assert pairs.count((1, 1)) == 3 * 2 + 2 + 3   # fwd x2, dx, dk
    assert pairs.count((1, 16)) == 2 + 1 and pairs.count((16, 1)) == 1
    assert pairs.count((16, 16)) == 2 + 1 + 1
    v = 8 * 128 ** 3
    # 16 -> 16 is bound by operations at 67 TFLOP/s, the rest by bytes
    t16 = 2 * 27 * 256 * v / 67e12
    t1_16 = (4 * v * 17 + 4 * 27 * 16) / 3.35e12
    t1 = (4 * v * 2 + 4 * 27) / 3.35e12
    want = 4 * t16 + 4 * t1_16 + 11 * t1
    assert counts.stencil_step_bound_s(CFG, H100) == pytest.approx(want)
    assert counts.stencil_step_bound_s(CFG, H100) * 1e3 == pytest.approx(
        15.649, abs=1e-3)
