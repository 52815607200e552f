"""``norm_ms`` on synthetic trace summaries: every BatchNorm kernel's
device time over the profiled steps, cuDNN's alone for a program without
the port's kernels, nothing without a trace or a BatchNorm kernel."""

import pytest

from benchmark import harness

READ = harness.reader('norm_ms')
CUDNN = {
    'void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, '
    '1>(cudnnTensorStruct, float const*)': 0.13987,
    'void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, true, '
    '1>(float, float)': 0.21146,
    'void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float)':
        0.003,
    'void cudnn::batchnorm_fwtr_nhwc_semiPersist<float, float, float, 512, '
    '16, 2, 4, 1, 0, false, false, true, 2>(cudnn::NhwcBatchNormFwdParams)':
        0.002,
    'void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512, '
    '16, 3, 4, 1, 0, true, 2>(cudnn::NhwcBatchNormBwdParams)': 0.004,
    'void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(float)':
        0.001,
}
PORT = {
    '(anonymous namespace)::bn_stats_partial(float const*, float*, int, '
    'long long, long long, long long, int)': 0.004,
    '(anonymous namespace)::bn_stats_combine(float const*, int, long long, '
    'long long, float, float*, float*, float*)': 0.0001,
    '(anonymous namespace)::bn_apply(float const*, float*, float const*, '
    'float const*, float const*, float const*, int, long long, long long, '
    'long long, int, int, float)': 0.006,
    '(anonymous namespace)::bn_grad_partial(float const*)': 0.007,
    '(anonymous namespace)::bn_grad_combine(float const*)': 0.0001,
    '(anonymous namespace)::bn_grad_input(float const*)': 0.008,
}
OTHER = {'void at::native::reduce_kernel<512, 1>(float)': 0.5,
         'void (anonymous namespace)::conv3x3x3_kernel<16>(float const*)':
             0.1}


def _record(kernels, steps=3):
    return dict(profile_steps=steps,
                trace=dict(kernel_s=kernels,
                           kernel_n={k: 1 for k in kernels}))


@pytest.mark.parametrize('kernels,want_s', [
    (dict(CUDNN, **OTHER), sum(CUDNN.values())),
    (dict(PORT, **OTHER), sum(PORT.values())),
    (dict(CUDNN, **PORT, **OTHER), sum(CUDNN.values()) + sum(PORT.values())),
])
def test_norm_ms_sums_batch_norm_kernels_over_steps(kernels, want_s):
    assert READ(_record(kernels)) == pytest.approx(1e3 * want_s / 3)


@pytest.mark.parametrize('record', [
    {}, dict(profile_steps=3, trace={}), _record(OTHER),
    _record(CUDNN, steps=0)])
def test_norm_ms_reads_nothing_without_batch_norm_kernels(record):
    assert READ(record) is None


def test_norm_ms_is_read_in_the_training_cells():
    m = harness.find(harness.bench()['per_layer'], 'norm_ms', 'metric')
    assert m['moves'] == 'train_step_s' and m['source'] == 'device_trace'
    assert m['workloads'] == ['list.train', 'coarsenet.train']
