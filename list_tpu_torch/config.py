"""Configuration: the JAX package's argparse namespace, flag for flag.

Same flag names and defaults as ``list_tpu/config.py`` (itself mirroring
the reference's ``arguments.py``), so an experiment command runs under
either package.  Flags ``_INERT`` here are inert in the JAX package too.
The port's own models add their flags where ``--model`` names one
(``_MODEL_FLAGS``: DISN's ``--vgg_widths`` ... ``--disn_camera``).
The JAX package's layout-only training flags (``--fuse_sample_gathers``,
``--collapse_samples``, ``--collapse_select``, ``--fc0_dmajor``,
``--sort_queries``, ``--percep_collapse``) compute the same values as
without them; the port accepts them and computes the plain path.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser, Namespace
from typing import Optional, Sequence

CATLIST_13 = [
    '03001627', '02691156', '02828884', '02933112', '03211117', '03636649',
    '03691459', '04090263', '04256520', '04379243', '04530566', '02958343',
    '04401088',
]

_INERT = 'accepted for CLI parity; inert in list_tpu_torch'


def _build_parser() -> ArgumentParser:
    p = ArgumentParser(description='Image_to_3D (LIST, PyTorch/CUDA port)')
    a = p.add_argument
    a('--cuda', type=bool, default=True)
    a('--gpu', type=int, default=0)
    a('--plot_every_batch', type=int, default=10)
    a('--save_every_epoch', type=int, default=25)
    a('--save_after_epoch', type=int, default=1)
    a('--test_every_epoch', type=int, default=25)
    a('--load_pretrain', type=bool, default=True)
    a('--skip_train', action='store_true')

    a('--viewnum', type=int, default=36)
    a('--img_res', type=int, default=224)
    a('--mcube_znum', type=int, default=128)
    a('--test_pointnum', type=int, default=65536)
    a('--chunk_s', type=int, default=0)
    a('--chunk_l', type=int, default=217)
    a('--chunk_id', type=int, default=0, help=_INERT)
    a('--chunk_num', type=int, default=4, help=_INERT)

    a('--model', type=str, help='Dotted path of the model')
    a('--dataset', type=str, help='Dotted path of the dataset')

    a('--random_h_flip', action='store_true')
    a('--color_jitter', action='store_true')
    a('--normalize', action='store_true')

    a('--point_decoder', action='store_true', help=_INERT)
    a('--warm_start', action='store_true')

    a('--lr', type=float, default=0.0001)
    a('--beta1', type=float, default=0.9)
    a('--cam_batch_size', type=int, default=16, help=_INERT)
    a('--cam_lr', type=float, default=0.00005, help=_INERT)
    a('--train_batch_size', type=int, default=12)
    a('--test_batch_size', type=int, default=1, help=_INERT)
    a('--epochs', type=int, default=300)
    a('--sampling_mode', type=str, default='weighted', help=_INERT)
    a('--exp_name', '-e', type=str, default='d2im+tGCN')
    a('--eval_pred', action='store_true')
    a('--supervise_proj', action='store_true', help=_INERT)
    a('--coarse_point_density', type=int, default=10000)
    a('--sample_point_density', type=int, default=32768)
    a('--sdf_max_dist', type=float, default=1.0)
    a('--sdf_scale', type=float, default=1.0)

    a('--weight_decay', type=float, default=1e-5)
    a('--sigmas', type=float, nargs='+', default=[0.003, 0.01, 0.07])
    a('--sample_distribution', type=float, nargs='+',
      default=[0.5, 0.49, 0.01])

    a('--point_feat', type=int, default=[128, 128, 256, 256, 256, 128, 128, 3],
      nargs='+', help='Features for point decoder.')
    a('--point_degree', type=int, default=[2, 2, 2, 2, 2, 2, 64], nargs='+',
      help='Upsample degrees for point decoder.')
    a('--im_enc_layers', type=int, default=[1, 1, 1, 1, 16, 32, 64, 128, 128],
      nargs='+', help='Layer dimensions for the voxel encoder.')

    a('--n_decoder_pos', type=int, default=2, help=_INERT)
    a('--bb_min', type=float, default=-0.5, help='Bounding box minimum.')
    a('--bb_max', type=float, default=0.5, help='Bounding box maximum.')
    a('--vox_res', type=int, default=128, help='Bounding box res.')

    a('--data_dir', default='./Datasets/shapenet/')
    a('--mesh_dir', default='./Datasets/shapenet/mesh/')
    a('--h5_dir', default='./Datasets/shapenet/sampled_points/')
    a('--cam_dir', default='./Datasets/shapenet/images/', help=_INERT)
    a('--image_dir', default='./Datasets/shapenet/images/')
    a('--catlist', type=str, default=list(CATLIST_13), nargs='+',
      help='category list.')

    a('--output_dir', default='./results/')
    a('--test_cam_id', type=int, default=2, help='Cam id to test with.')
    a('--test_gpu_id', type=int, default=0, help=_INERT)
    a('--test_checkpoint', default='best_model_test.ckpt')
    a('--testlist_file', default='./data/DISN_split/testlist_all.lst')
    a('--split_dir', default='./data/DISN_split',
      help='Directory holding <cat>_{train,test}.lst split files.')

    # ---- additions of the JAX package (same names and defaults) ----
    a('--seed', type=int, default=333, help='Global seed.')
    a('--mesh_shape', type=int, nargs='+', default=None,
      help='N (or D Q: Q when above 1, else D) local devices that split '
           'one image\'s dense decode by x rows; training is data-parallel '
           'over the --multihost processes.')
    a('--dtype', type=str, default='float32',
      choices=['float32', 'bfloat16'], help=_INERT)
    a('--fast_grid', type=int, default=1,
      help='Dense-grid decode (1) or the chunked general decoder (0).')
    a('--fetch_dtype', type=str, default='bfloat16',
      choices=['float32', 'bfloat16'],
      help='dtype the dense SDF grid is cast to on the device before the '
           'device->host copy (upcast to f32 on the host).')
    a('--fetch_mode', type=str, default='band', choices=['grid', 'band'],
      help='Device->host wire format of the dense grid: "band" (default) '
           'packs the sign bits and the exact values of the cells of mixed '
           'marching-cubes cubes on the device (~0.77 MB per 128^3 mesh; '
           'the same mesh as the full grid, which is fetched on overflow); '
           '"grid" copies the whole --fetch_dtype grid.')
    a('--infer_batch', type=int, default=1,
      help='Meshes decoded per batched encoder pass in a test sweep.')
    a('--use_pallas', type=int, default=-1,
      help='Dense-decode head: -1 (default) the structured K1 head on '
           'the card (one slab at R <= 128, else slabs of the largest '
           'divisor of R in 64..2); 0 the plain PyTorch head; 1 the '
           'per-scale t-major K4 head; 2 the structured K1 head.  The CPU '
           'always takes the plain head.')
    a('--percep_collapse', type=int, default=-1,
      help='Layout-only in the JAX package (identical math); the port '
           'computes the plain 4-corner gather.')
    a('--remat', type=int, default=1)
    a('--remat_decode', type=int, default=-1)
    a('--fuse_sample_gathers', type=int, default=0)
    a('--collapse_samples', type=str, default='auto')
    a('--collapse_select', type=int, default=0)
    a('--fc0_dmajor', type=int, default=0)
    a('--remat_save_samples', type=int, default=0,
      help='Under decode remat with --train_query_chunks above 1, keep the '
           'named sampled feature stacks for the backward instead of '
           'recomputing them: the backward then skips the forward\'s '
           're-gathers, at the cost of the stacks\' memory (the voxel '
           'stack is 7 x 369 values a query at the default spec, the '
           'perceptual one 1,024). 0 = full remat; 1 = keep the voxel '
           'samples; 2 = keep the voxel and the perceptual samples.')
    a('--steps_per_dispatch', type=int, default=1)
    a('--sort_queries', type=int, default=0)
    a('--train_query_chunks', type=int, default=4)
    a('--resnet_ckpt', type=str, default='')
    a('--mesh_renorm', type=str, default='reference',
      choices=['reference', 'exact'],
      help='"reference" keeps the reference global-scalar vertex renorm; '
           '"exact" maps grid indices to world coordinates.')
    a('--profile_dir', type=str, default='')
    a('--num_workers', type=int, default=4)
    a('--multihost', type=int, default=0,
      help='1: join a torch.distributed process group (the next three '
           'flags, else COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID): '
           'data-parallel training with global-batch BatchNorm, a sweep '
           'sharded over the processes.')
    a('--coordinator_address', type=str, default='',
      help='host:port of rank 0 (--multihost 1).')
    a('--num_processes_dist', type=int, default=0,
      help='Number of processes (--multihost 1).')
    a('--process_id', type=int, default=-1,
      help='This process\'s rank; it runs on card rank %% device_count '
           '(--multihost 1).')
    a('--checkify', action='store_true',
      help='NaN/inf guards in the single train step (debugging): forward '
           'and backward under torch.autograd.detect_anomaly, and every '
           'loss and gradient checked finite before the optimizer step; a '
           'step that fails raises FloatingPointError and leaves the '
           'parameters, Adam state, BatchNorm statistics and step count '
           'as they were.  --steps_per_dispatch falls back to single '
           'steps.')
    return p


def _disn_flags(p: ArgumentParser) -> None:
    """The flags of DISN (``models/disn.py``), a model of the port alone."""
    a = p.add_argument
    a('--vgg_widths', type=int, nargs=5, default=[64, 128, 256, 512, 512],
      help='DISN: channels of the VGG-16 encoder\'s five blocks (2, 2, 3, '
           '3 and 3 convolutions).')
    a('--vgg_fc', type=int, nargs='+', default=[4096, 4096, 1024],
      help='DISN: fc6, fc7 and fc8; fc8 is the global feature.')
    a('--disn_point', type=int, nargs='+', default=[64, 256, 512],
      help='DISN: each stream\'s point MLP after xyz.')
    a('--disn_head', type=int, nargs='+', default=[512, 256],
      help='DISN: each stream\'s layers between [point | image feature] '
           'and its 1-wide output.')
    a('--disn_camera', type=float, nargs=12,
      default=[136 / 1.2, 0.0, 0.0, 0.0, -136 / 1.2, 0.0, 0.0, 0.0, 0.0,
               68.0, 68.0, 1.0],
      help='DISN: the (4, 3) camera, row-major, mapping (x, y, z, 1) to '
           '(u, v, depth) on the 137^2 maps, for images without their '
           'own; the default is the synthetic renders\' orthographic '
           'view.')


# Flags of the port's own models, by the model's resolved path: parsed only
# where --model names one, so that every other command line parses to the
# JAX package's namespace.
_MODEL_FLAGS = {'list_tpu_torch.models.disn.DISN': _disn_flags}


def _parser(model: Optional[str]) -> ArgumentParser:
    from list_tpu_torch.registry import resolve
    p = _build_parser()
    add = _MODEL_FLAGS.get(resolve(model)) if model else None
    if add is not None:
        add(p)
    return p


def _validate(args: Namespace) -> None:
    fg = int(getattr(args, 'fuse_sample_gathers', 0))
    if fg not in (0, 1):
        raise ValueError(f'--fuse_sample_gathers {fg}: use 0 or 1.')
    tqc = int(getattr(args, 'train_query_chunks', 4))
    if tqc < 1:
        raise ValueError(f'--train_query_chunks {tqc}: must be >= 1.')


def _finalize(args: Namespace) -> Namespace:
    """Derive testlist and output dirs as the reference does."""
    _validate(args)
    testlist = []
    if args.testlist_file and os.path.exists(args.testlist_file):
        with open(args.testlist_file, 'r') as f:
            lines = f.readlines()
        for line in lines[:30]:
            fn = line.strip()
            if fn:
                fn = fn.split(' ')
                if fn[0] in args.catlist:
                    testlist.append(
                        {'cat_id': fn[0], 'shape_id': fn[1], 'cam_id': fn[2]})
    args.testlist = testlist
    args.checkpoint_dir = args.output_dir + args.exp_name + '/checkpoints/'
    args.results_dir = args.output_dir + args.exp_name + '/'
    args.log = args.output_dir + args.exp_name + '/log.txt'
    return args


def get_args(argv: Optional[Sequence[str]] = None) -> Namespace:
    """Parse CLI args (pass ``argv`` for programmatic use)."""
    known, _ = _build_parser().parse_known_args(argv)
    return _finalize(_parser(known.model).parse_args(argv))


def default_config(**overrides) -> Namespace:
    """Programmatic config with the CLI defaults; ``overrides`` apply before
    the derived fields are computed."""
    args = _parser(overrides.get('model')).parse_args([])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise ValueError(f'Unknown config field: {k}')
        setattr(args, k, v)
    return _finalize(args)
