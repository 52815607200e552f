"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside the wrapper:

- ``stencil3d.conv3x3x3`` (K2): the voxel encoder's full-resolution
  3x3x3 convolutions, forward and the backward's dx.
- ``stencil3d.conv3x3x3_dk`` (K3): their weight gradients.
- ``fused_fc0.fused_stack_head`` (K1): the dense-grid SDF decoder head.
- ``fused_fc0.fused_fc0_mlp`` (K4): the ``--use_pallas 1`` decoder head
  over per-scale t-major tap stacks.
- ``batch_norm``: BatchNorm of few-channel volumes (the voxel encoder's),
  training forward, backward and eval.
- ``percep.percep_sample``: the dense decode's perceptual sample, the
  projected map's four-corner bilinear at each query's pixel (LIST's and
  DISN's decodes).
- ``voxel`` (``voxel_taps``): LIST's dense-decode voxel work, the kept
  groups' seven taps and the coarse-projected scales' summed term at the
  query grid.
"""

KERNEL_SOURCES = ('stencil3d', 'conv3x3x3_dk', 'fused_stack_head',
                  'fused_fc0_mlp', 'batch_norm', 'percep_sample',
                  'voxel_taps')


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    from list_tpu_torch.ops.cuda import (batch_norm, fused_fc0, percep,
                                         stencil3d, voxel)
    stencil3d.launches = stencil3d.dx_launches = stencil3d.dk_launches = 0
    fused_fc0.launches = fused_fc0.mlp_launches = 0
    batch_norm.launches = batch_norm.bwd_launches = 0
    percep.launches = 0
    voxel.launches = 0


def launch_counts() -> dict:
    """Each kernel's launches since the last reset (``conv3x3x3_dx``: the
    K2 launches made for a backward's dx, a subset of ``conv3x3x3``;
    ``batch_norm``: the BatchNorm forwards that ran the kernels, training
    at one channel and eval; ``batch_norm_bwd``: its backwards;
    ``percep_sample``: one a slab of every dense decode on the card;
    ``voxel_taps``: one a kept group a slab of LIST's dense decode and one
    for its coarse term, once a decode or once a slab)."""
    from list_tpu_torch.ops.cuda import (batch_norm, fused_fc0, percep,
                                         stencil3d, voxel)
    return dict(conv3x3x3=stencil3d.launches,
                conv3x3x3_dx=stencil3d.dx_launches,
                conv3x3x3_dk=stencil3d.dk_launches,
                fused_stack_head=fused_fc0.launches,
                fused_fc0_mlp=fused_fc0.mlp_launches,
                batch_norm=batch_norm.launches,
                batch_norm_bwd=batch_norm.bwd_launches,
                percep_sample=percep.launches,
                voxel_taps=voxel.launches)
