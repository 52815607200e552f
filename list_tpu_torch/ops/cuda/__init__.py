"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside the wrapper:

- ``stencil3d.conv3x3x3`` (K2): the voxel encoder's full-resolution
  3x3x3 convolutions, forward and the backward's dx.
- ``stencil3d.conv3x3x3_dk`` (K3): their weight gradients.
- ``fused_fc0.fused_stack_head`` (K1): the dense-grid SDF decoder head.
- ``fused_fc0.fused_fc0_mlp`` (K4): the ``--use_pallas 1`` decoder head
  over per-scale t-major tap stacks.
"""

KERNEL_SOURCES = ('stencil3d', 'conv3x3x3_dk', 'fused_stack_head',
                  'fused_fc0_mlp')
