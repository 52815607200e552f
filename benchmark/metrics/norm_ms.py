"""BatchNorm's device ms a training step: every BatchNorm kernel in the
profiled sub-window over its steps.  The kernels, by the names the
profiler gives them: cuDNN's (training forward, backward and eval
forward: ``bn_*_1C11`` on channel-major inputs, ``batchnorm_*_nhwc`` on
the ResNets' channels-last ones), PyTorch's own (``batch_norm_*``, where
cuDNN is not taken) and the port's (``csrc/batch_norm.cu``:
``bn_stats_*``, ``bn_apply``, ``bn_grad_*``).  A program without the port's kernels reads its cuDNN
time alone.  Each kernel name is counted once, whichever needles it
holds."""

NEEDLES = ('bn_fw_tr', 'bn_bw', 'bn_fw_inf', 'batchnorm_', 'batch_norm_',
           'bn_stats_', 'bn_apply', 'bn_grad_')


def read(record):
    s, steps = record.get('trace', {}), record.get('profile_steps')
    names = [n for n in s.get('kernel_s', {})
             if any(k in n for k in NEEDLES)]
    if not names or not steps:
        return None
    return 1e3 * sum(s['kernel_s'][n] for n in names) / steps
