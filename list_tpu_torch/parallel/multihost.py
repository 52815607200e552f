"""Multi-process runtime (counterpart of ``list_tpu/parallel/multihost.py``)
on ``torch.distributed``.

Every process runs the same program; ``initialize`` joins them into one
process group over TCP, and the group takes the place of the JAX
package's ``data`` mesh axis: the train step takes this rank's rows of the
global batch and all-reduces its gradients and BatchNorm moments
(``train/executors.py``, ``models/norm.py``), the trainer writes from
rank 0 only, and a sweep takes this rank's strided share of the test list
and writes its own ``<cat>_p{rank}.csv``.

Usage (one command per process; ``N`` processes, ``i`` = 0..N-1, each on
card ``i % device_count``):

    COORDINATOR_ADDRESS=host0:9911 NUM_PROCESSES=N PROCESS_ID=$i \\
        python train_torch.py ... --multihost 1

The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU.  A
caller that puts two ranks on one card passes ``backend='gloo'`` (NCCL
refuses two ranks on one GPU).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from list_tpu_torch.device import resolve_device

_device: Optional[torch.device] = None
_moments = None  # the BatchNorm moments' process group (world > 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None) -> int:
    """Join the process group; returns this process's rank.

    The three arguments default from COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID, as in the JAX package.  A second call is a no-op, and so is
    an explicit single-process run (num_processes == 1 with no
    coordinator).  ``device`` defaults to ``cuda:{process_id %
    device_count}`` (raising without a card); ``backend`` to ``nccl`` for
    a CUDA device, else ``gloo``."""
    global _device, _moments
    if dist.is_initialized():
        return dist.get_rank()
    coordinator_address = (coordinator_address
                           or os.environ.get('COORDINATOR_ADDRESS'))
    if num_processes is None:
        num_processes = int(os.environ.get('NUM_PROCESSES', 0)) or None
    if process_id is None:
        pid = os.environ.get('PROCESS_ID')
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None and num_processes == 1:
        return 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            'list_tpu_torch multihost: a coordinator address, the number '
            'of processes and this process id are all needed (flags '
            '--coordinator_address/--num_processes_dist/--process_id or '
            'COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID)')
    if device is None:
        resolve_device('cuda')  # raises without a card
        device = f'cuda:{process_id % torch.cuda.device_count()}'
    dev = resolve_device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    dist.init_process_group(backend, init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)
    _device = dev
    if num_processes > 1:
        # BatchNorm's moments go through a group of their own: under remat
        # the backward recomputes a forward, whose all-reduces then never
        # queue among the gradient all-reduce's on one communicator
        _moments = dist.new_group(backend=backend)
    return process_id


def maybe_initialize(config, backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> int:
    """Driver hook: join the group when ``--multihost 1``; otherwise a
    no-op returning 0."""
    if not int(getattr(config, 'multihost', 0)):
        return 0
    return initialize(
        coordinator_address=(getattr(config, 'coordinator_address', '')
                             or None),
        num_processes=int(getattr(config, 'num_processes_dist', 0)) or None,
        process_id=(int(config.process_id)
                    if int(getattr(config, 'process_id', -1)) >= 0 else None),
        backend=backend, device=device)


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _device, _moments
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = _moments = None


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device() -> Optional[torch.device]:
    """The device ``initialize`` gave this rank (None outside a group)."""
    return _device if dist.is_initialized() else None


def moments_group():
    """The process group of the BatchNorm moments, or None unless more
    than one rank trains."""
    return _moments if dist.is_initialized() else None


def shard_datalist(datalist: Sequence, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> list:
    """Strided per-process slice of an eval/test list (``datalist[i::n]``),
    so the category blocks of a sorted test list spread over the
    processes."""
    rank, world = process_info()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = world
    if process_count <= 1:
        return list(datalist)
    return list(datalist)[process_index::process_count]


def sync_global_devices(tag: str = 'barrier') -> None:
    """Cross-process barrier (``tag`` names it, as in the JAX package)."""
    if process_info()[1] > 1:
        dist.barrier()
