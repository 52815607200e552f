"""Generic training driver (counterpart of ``list_tpu/train/trainer.py``;
reference: train.py:22-325).

Model, dataset and executor resolved from dotted config strings,
checkpoint auto-resume from ``best_model_train`` (weights, Adam state,
epoch, best losses), warm start (``best_IME_test`` into ``im_encoder`` and
``im_encoder2``, ``best_PD_test`` into ``point_decoder``, the first and
last frozen), the epoch loop with the periodic in-training eval on the
testlist, periodic / best-train / best-test checkpoints in the JAX
package's format (the best test model by IoU, else Chamfer), scalar
logging, and ``--profile_dir`` (a ``torch.profiler`` trace of the first
epoch).  ``train(config, device=None)`` runs on the card unless the caller
passes ``device='cpu'``.  Under ``--multihost 1`` every process trains
data-parallel on the same global batches (``parallel.multihost``; each on
its rank's card), runs the testlist eval and reaches the same best-model
decision; only rank 0 writes checkpoints, logs, summaries and the trace.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from list_tpu_torch import registry
from list_tpu_torch.data.loader import DataLoader
from list_tpu_torch.parallel import multihost
from list_tpu_torch.train import checkpoints as ckpt
from list_tpu_torch.utils.logging import SummaryWriter, print_log

CKPT_FORMAT = 'flax'  # the JAX package's .ckpt: both packages read it


def build_model(config):
    model_cls = registry.get_class(config.model)
    if hasattr(model_cls, 'from_config'):
        return model_cls.from_config(config)
    return model_cls(config)


def build_executor(config, model, **kw):
    exec_cls = registry.get_class(registry.executor_for(config.model))
    return exec_cls(config, model, **kw)


def test_epoch(executor, dataset, cat_id, shape_id, cam_id, output_dir,
               eval_pred=False, write=True) -> Dict[str, float]:
    if write:
        os.makedirs(os.path.join(output_dir, cat_id), exist_ok=True)
    batch = dataset.get_testdata(cat_id, shape_id, cam_id)
    pred, eval_score = executor.test(batch, eval_pred)
    if write:
        fname = os.path.join(output_dir, cat_id, f'{shape_id}_{cam_id}')
        executor.save(batch, pred, fname)
    return eval_score


def run_testlist(epoch, executor, dataset, config, testlist,
                 write=True) -> Dict[str, float]:
    """Accumulate eval scores over the testlist (reference: train.py:37-60;
    NaNs skipped per train.py:53-54)."""
    eval_scores: Dict[str, float] = {}
    output_dir = os.path.join(config.results_dir, f'epoch_{epoch + 1}')
    if write:
        os.makedirs(output_dir, exist_ok=True)
    for testdata in testlist:
        eval_score = test_epoch(executor, dataset, testdata['cat_id'],
                                testdata['shape_id'], testdata['cam_id'],
                                output_dir, config.eval_pred, write=write)
        for k, v in eval_score.items():
            if np.isnan(v):
                continue
            eval_scores[k] = eval_scores.get(k, 0.0) + v
    return eval_scores


def _step_losses(executor, config, data_iter):
    """Yield per-step host loss dicts, honoring --steps_per_dispatch: K
    batches at a time through ``executor.train_multi`` (K steps, the K
    losses back together); a ragged tail (< K batches left) takes single
    steps, as the JAX package does."""
    k = int(getattr(config, 'steps_per_dispatch', 1) or 1)
    if k <= 1:
        for batch in data_iter:
            _, batch_loss = executor.train(batch=batch, calc_loss=True)
            yield {kk: float(v) for kk, v in batch_loss.items()}
        return
    group = []
    for batch in data_iter:
        group.append(batch)
        if len(group) == k:
            _, stacked = executor.train_multi(group)
            host = {kk: v.cpu().numpy() for kk, v in stacked.items()}
            for i in range(k):
                yield {kk: float(v[i]) for kk, v in host.items()}
            group = []
    for batch in group:  # ragged tail: single steps
        _, batch_loss = executor.train(batch=batch, calc_loss=True)
        yield {kk: float(v) for kk, v in batch_loss.items()}


def train_one_epoch(epoch, executor, data_iter, config, writer) -> float:
    losses: Dict[str, float] = {'total_loss': 0.0}
    epoch_start = time.time()
    n_batches = len(data_iter)
    batch_idx = -1
    step_iter = _step_losses(executor, config, data_iter)
    while True:
        iter_start = time.time()
        try:
            batch_loss = next(step_iter)
        except StopIteration:
            break
        batch_idx += 1
        loss = sum(v for k, v in batch_loss.items() if 'ignore' not in k)
        for k, v in batch_loss.items():
            losses[k] = losses.get(k, 0.0) + v
        losses['total_loss'] += loss

        if ((batch_idx + 1) % config.plot_every_batch == 0
                or batch_idx == n_batches - 1):
            t = time.time()
            eta = (t - epoch_start) / (batch_idx + 1) * n_batches \
                - (t - epoch_start)
            logline = (f'Epoch: {epoch + 1:03d}||{config.epochs}, '
                       f'batch: {batch_idx + 1:03d}||{n_batches}, ')
            for k, v in batch_loss.items():
                logline += f'{k}: {v:9.5f}, '
            logline += (f'batch_total_loss: {loss:9.5f} '
                        f'batch_time: {(t - iter_start):0.5f} '
                        f'ETA: {int(eta // 60):02d}m'
                        f':{int(eta - 60 * (eta // 60)):02d}s')
            print(logline)

    n = max(batch_idx + 1, 1)
    mean_loss = losses['total_loss'] / n
    print(f'{config.exp_name} Train: Epoch {epoch + 1:03d}||{config.epochs}, '
          f'loss: {mean_loss:9.5f} '
          f'epoch_time: {(time.time() - epoch_start):0.5f}')
    for k, v in losses.items():
        if v != 0.0:
            writer.add_scalar(f'Train: Mean {k}', v / n, epoch)
    return mean_loss


def _maybe_load_resnet(executor, config) -> None:
    """--resnet_ckpt: pretrained ResNet18 weights for the image encoders,
    applied right after construction (checkpoint restores override them,
    the reference's construct-then-restore order, train.py:124-178)."""
    path = getattr(config, 'resnet_ckpt', '')
    if not path:
        return
    from list_tpu_torch.utils.torch_port import apply_resnet_ckpt
    loaded = apply_resnet_ckpt(executor.model, path)
    print(f'resnet_ckpt {path} loaded into: {", ".join(loaded)}')


def _save(executor, epoch, loss, path) -> None:
    ckpt.save_checkpoint(epoch, executor.model, loss, path,
                         optimizer=executor.optimizer, step=executor.step,
                         fmt=CKPT_FORMAT)


class _NullWriter:
    """Stand-in for ``SummaryWriter`` on the ranks other than 0 (one process
    owns the shared results directory)."""

    def add_scalar(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def close(self):
        pass


def train(config, device=None) -> None:
    # join the process group before any device use; the parameters and
    # Adam state stay identical on every rank, so rank 0 writes for all
    multihost.maybe_initialize(config, device=device)
    device = device or multihost.rank_device()
    primary = multihost.process_info()[0] == 0
    model = build_model(config)
    Dataset = registry.get_class(registry.resolve(config.dataset))
    trainset = Dataset(config, 'train')
    if hasattr(trainset, 'ensure_occupancies'):
        # Precompute occupancy caches before workers start (kills the
        # reference's h5-write-during-training race, Datasets.py:242-252).
        trainset.ensure_occupancies()
    train_iter = DataLoader(trainset, batch_size=config.train_batch_size,
                            shuffle=True, num_workers=config.num_workers,
                            drop_last=True,
                            seed=getattr(config, 'seed', 333))
    executor = build_executor(config, model, device=device)
    # the JAX package draws one batch here to size its state; drawn too,
    # so the epochs see the same shuffles of one seed
    next(iter(train_iter))

    epoch = 0
    best_train_loss = 1e3
    best_test_score = 1e3
    best_test_epoch = 0

    ckpt_dir = config.checkpoint_dir
    os.makedirs(ckpt_dir, exist_ok=True)
    best_test_path = os.path.join(ckpt_dir, 'best_model_test.ckpt')
    best_train_path = os.path.join(ckpt_dir, 'best_model_train.ckpt')

    if config.load_pretrain and os.path.exists(best_train_path):
        executor.init_optimizer()
        _maybe_load_resnet(executor, config)
        ep, best_loss, executor.step = ckpt.load_checkpoint(
            best_train_path, executor.model, with_step=True,
            optimizer=executor.optimizer)
        epoch = ep
        best_train_loss = best_loss
        if os.path.exists(best_test_path):
            best_test_epoch, best_test_score = ckpt.load_checkpoint(
                best_test_path, None)
        print(f'pretrained model loaded at epoch: {epoch}, '
              f'best train loss: {best_loss}')
    elif config.load_pretrain and config.warm_start:
        # Warm start: restore best_IME/best_PD into im_encoder, im_encoder2,
        # point_decoder; freeze im_encoder & point_decoder (im_encoder2
        # trainable) — reference train.py:183-229.
        print('Checking for warm start checkpoints!!')
        prefix = 'coarse_prediciton_Pix3D' if 'Pix3D' in config.exp_name \
            else 'coarse_prediciton'
        ime = os.path.join(config.output_dir, prefix, 'checkpoints',
                           'best_IME_test.ckpt')
        pd = os.path.join(config.output_dir, prefix, 'checkpoints',
                          'best_PD_test.ckpt')
        executor.init_optimizer(frozen_prefixes=('im_encoder',
                                                 'point_decoder'))
        _maybe_load_resnet(executor, config)
        if os.path.exists(ime):
            ckpt.load_submodule(ime, executor.model, 'im_encoder')
            ckpt.load_submodule(ime, executor.model, 'im_encoder2')
            print(config.exp_name, 'Im E 1+2 checkpoints loaded')
        if os.path.exists(pd):
            ckpt.load_submodule(pd, executor.model, 'point_decoder')
            print(config.exp_name, 'PD checkpoint loaded')
        if primary:
            _save(executor, -1, best_train_loss, best_train_path)
            print('Initial checkpoint saved.')
    else:
        executor.init_optimizer()
        _maybe_load_resnet(executor, config)

    writer = (SummaryWriter(os.path.join(config.results_dir, 'summary'))
              if primary else _NullWriter())
    writer.add_text('opt', str(config), 0)

    profiler = None
    if primary and getattr(config, 'profile_dir', ''):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if executor.device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    while epoch < config.epochs:
        if not config.skip_train:
            loss = train_one_epoch(epoch, executor, train_iter, config,
                                   writer)
            if primary and (epoch + 1) % config.save_every_epoch == 0:
                _save(executor, epoch, loss,
                      os.path.join(ckpt_dir, f'model_{epoch + 1}.ckpt'))
            if best_train_loss > loss:
                best_train_loss = loss
                if primary:
                    _save(executor, epoch, loss, best_train_path)

        if (epoch + 1) % config.test_every_epoch == 0:
            # every rank evaluates the same testlist with the same weights,
            # so the best-model decision advances alike; rank 0 writes
            eval_start = time.time()
            eval_scores = run_testlist(epoch, executor, trainset, config,
                                       config.testlist, write=primary)
            n_test = max(len(config.testlist), 1)
            # best-model selection prefers IoU, then chamfer (train.py:270-277)
            if config.eval_pred and 'iou' in eval_scores \
                    and not np.isnan(eval_scores['iou']):
                test_score = 1.0 - eval_scores['iou'] / n_test
            elif config.eval_pred and 'chamfer_l2' in eval_scores:
                test_score = eval_scores['chamfer_l2'] / n_test
            else:
                test_score = best_test_score

            if best_test_score > test_score \
                    and (epoch + 1) >= config.save_after_epoch:
                best_test_score = test_score
                best_test_epoch = epoch + 1
                if primary:
                    _save(executor, epoch, test_score, best_test_path)

            logline = (f'{config.exp_name} Test: Epoch '
                       f'{epoch + 1:03d}||{config.epochs} ')
            for k, v in eval_scores.items():
                logline += f'{k}: {v / n_test:7.3f}, '
                writer.add_scalar(f'Test: Mean {k}', v / n_test, epoch + 1)
            logline = logline[:-2] + (
                f' Best Score: {best_test_score:7.3f} '
                f'Best Epoch: {best_test_epoch:03d} '
                f'time: {(time.time() - eval_start):0.5f}')
            if primary:
                print(logline)
                print_log(config.log, logline)

        epoch += 1
        if profiler is not None:  # the trace covers the first epoch
            profiler.stop()
            os.makedirs(config.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(config.profile_dir, 'trace.json'))
            profiler = None
    writer.close()
