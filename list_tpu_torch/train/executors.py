"""Executors (counterpart of ``list_tpu/train/executors.py``).

An executor ``(config, model, device=None)`` owns the model on its device
(``cuda`` unless the caller passes ``device='cpu'``) in eval mode, and its
optimizer (``init_optimizer``, built at the first step when not before).
``train(batch)`` runs one optimizer step on a host batch dict (forward in
train mode, the losses, backward, Adam) and returns ``(None, losses)``,
recording ``timings['step_s']``; ``train_multi(batches)`` runs one step
per batch and returns (K,) losses.  The model is in train mode only inside
a step.

Under a process group (``parallel.multihost``, the JAX package's ``data``
mesh axis) the executor is data-parallel with plain collectives: rank 0's
parameters and buffers are broadcast at construction; ``train(batch)``
takes the global batch and keeps this rank's rows (``parallel.mesh``);
after the step's one backward pass the gradients of the optimizer's
parameters are all-reduced once, as one flat buffer, and divided by the
world size; the returned losses are the ranks' mean.  Parameters, Adam
state and (through ``models/norm.py``'s global-batch BatchNorm) the
running statistics stay bit-identical on every rank.

- ``CoarseNetExecutor`` (stage 1): the Chamfer loss of the predicted
  cloud against the batch's ``pc``; ``test`` predicts one image's cloud
  (and with ``eval_pred`` scores it with ``eval_pointcloud``), ``save``
  writes it as an ``.obj`` of vertices.
- ``LISTExecutor`` (stage 2): the occupancy and SDF losses.
  ``predict_grid`` runs encode + dense-grid decode + the ``sdf_scale``
  divide + the ``--fetch_dtype`` cast (+ the ``--fetch_mode band`` encode)
  on the device and returns the (R, R, R) f32 host grid, or with
  ``device_out`` the device result (a ``BandGrid`` in band mode) for a
  fetch worker, without waiting for the device on the card (the result
  carries the CUDA event its fetch waits on); ``predict_grid_batch``
  encodes B images in one pass and decodes each; ``test`` adds marching
  cubes and, with ``eval_pred``, the mesh metrics.
- Under ``--checkify`` a single train step is checked for non-finite
  losses and gradients (``_optimizer_step``).
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from list_tpu_torch.device import resolve_device
from list_tpu_torch.eval.metrics import eval_mesh, eval_pointcloud
from list_tpu_torch.ops.band import (BandGrid, band_encode, fetch_grid_f32,
                                     mark_ready)
from list_tpu_torch.ops.dense_grid import dense_grid_slabs
from list_tpu_torch.ops.grid import create_grid_points_from_bounds
from list_tpu_torch.ops.losses import chamfer_loss, occupancy_loss, sdf_loss
from list_tpu_torch.parallel.mesh import shard_batch
from list_tpu_torch.train.state import make_optimizer
from list_tpu_torch.utils.meshing import generate_mesh
from list_tpu_torch.utils.meshio import write_obj
from list_tpu_torch.utils.spans import DeviceSpans, span


def total_loss(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of all entries whose key does not contain 'ignore'."""
    total = 0.0
    for k, v in loss_dict.items():
        if 'ignore' not in k:
            total = total + v
    return total


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat buffer of ``tensors`` (one dtype and
    device) and copy the result back in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(f.view_as(t))


class BaseExecutor:
    def __init__(self, config, model: torch.nn.Module, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.timings: Dict[str, float] = {}
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0
        self._checkify = bool(getattr(config, 'checkify', False))
        self.distributed = dist.is_initialized()
        if self.distributed:
            with torch.no_grad():
                state = list(self.model.state_dict().values())
                for dt in {t.dtype for t in state}:
                    _coalesced([t for t in state if t.dtype == dt],
                               lambda f: dist.broadcast(f, src=0))

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def init_optimizer(self, frozen_prefixes: Sequence[str] = ()
                       ) -> torch.optim.Adam:
        c = self.config
        self.optimizer = make_optimizer(
            self.model.named_parameters(), c.lr, c.beta1,
            weight_decay=c.weight_decay, frozen_prefixes=frozen_prefixes)
        return self.optimizer

    def _to_device(self, keep) -> Dict[str, torch.Tensor]:
        """Host arrays -> device tensors, floats in the parameters' dtype."""
        dtype = next(self.model.parameters()).dtype
        dev = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in keep.items()}
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in dev.items()}

    def _optimizer_step(self, losses_fn: Callable[[], Dict], t0: float):
        """One step of ``losses_fn`` (the forward and its loss dict) in
        train mode -> (None, detached losses); ``step_s`` from ``t0``.
        Its spans (``utils/spans.py``): ``step.forward`` (the forward and
        the losses), ``step.backward`` and, under a process group,
        ``step.allreduce`` (the gradients' and the losses' all-reduces).

        Under ``--checkify`` (single steps; ``train_multi`` is unchecked,
        as in the JAX package) the forward and backward run under
        ``torch.autograd.detect_anomaly`` and, after the gradient
        all-reduce and the loss mean over the ranks (so every rank sees
        the same values and raises together), every loss and gradient must
        be finite before Adam applies them.  A failing step raises
        ``FloatingPointError`` and restores the BatchNorm statistics the
        forward updated in place; the parameters, the Adam state and
        ``step`` were not touched."""
        if self.optimizer is None:
            self.init_optimizer()
        buffers = ({k: v.clone() for k, v in self.model.named_buffers()}
                   if self._checkify else None)
        self.model.train()
        try:
            self.optimizer.zero_grad(set_to_none=True)
            with (torch.autograd.detect_anomaly(
                    check_nan=not self.distributed) if self._checkify
                  else contextlib.nullcontext()):
                with span('step.forward', self.device):
                    losses = losses_fn()
                    total = total_loss(losses)
                with span('step.backward', self.device):
                    total.backward()
            losses = {k: v.detach() for k, v in losses.items()}
            if self.distributed:
                with span('step.allreduce', self.device):
                    self._all_reduce_grads()
                    losses = self._mean_over_ranks(losses)
            if self._checkify:
                self._check_finite(losses)
            self.optimizer.step()
        except FloatingPointError:
            self._undo_step(buffers)
            raise
        except RuntimeError as e:
            # one process: detect_anomaly raises from inside the backward
            if buffers is None or 'returned nan values' not in str(e):
                raise
            self._undo_step(buffers)
            raise FloatingPointError(f'--checkify: {e}') from e
        finally:
            self.model.eval()
        self.step += 1
        self._sync()
        self.timings['step_s'] = time.perf_counter() - t0
        return None, losses

    def _undo_step(self, buffers: Dict[str, torch.Tensor]) -> None:
        """Put back the buffers (BatchNorm statistics) saved before a
        failed step and drop its gradients."""
        with torch.no_grad():
            for k, v in self.model.named_buffers():
                v.copy_(buffers[k])
        self.optimizer.zero_grad(set_to_none=True)

    def _check_finite(self, losses: Dict[str, torch.Tensor]) -> None:
        """Raise ``FloatingPointError`` naming the first non-finite loss,
        else the first parameter with a non-finite gradient."""
        named = list(losses.items()) + [
            (f'the gradient of {k}', p.grad)
            for k, p in self.model.named_parameters() if p.grad is not None]
        ok = torch.stack([torch.isfinite(v).all() for _, v in named]).cpu()
        if not bool(ok.all()):
            name = named[int((~ok).nonzero()[0])][0]
            raise FloatingPointError(f'--checkify: {name} is not finite')

    def _rank_batch(self, batch):
        """This rank's rows of a global host batch (all of it in one
        process)."""
        return shard_batch(batch) if self.distributed else batch

    def _all_reduce_grads(self) -> None:
        """The optimizer's gradients, summed over the ranks in one flat
        buffer and divided by the world size: the global batch's."""
        world = dist.get_world_size()
        grads = [p.grad for g in self.optimizer.param_groups
                 for p in g['params'] if p.grad is not None]
        _coalesced(grads, lambda f: (dist.all_reduce(f), f.div_(world)))

    def _mean_over_ranks(self, losses: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        flat = torch.stack([v.double() for v in losses.values()])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        return {k: f.to(v.dtype) for (k, v), f in zip(losses.items(), flat)}

    def train_multi(self, batches):
        """One step per batch, in order -> (None, {key: (K,) losses});
        unchecked under ``--checkify``, as the JAX package's multi-step
        dispatch is."""
        checkify, self._checkify = self._checkify, False
        try:
            steps = [self.train(b)[1] for b in batches]
        finally:
            self._checkify = checkify
        return None, {k: torch.stack([s[k] for s in steps])
                      for k in steps[0]}


class CoarseNetExecutor(BaseExecutor):
    """Stage-1 executor."""

    def __init__(self, config, model: torch.nn.Module, device=None):
        super().__init__(config, model, device)
        self.eval_fn = eval_pointcloud

    def train(self, batch, calc_loss: bool = True):
        """One optimizer step on a host batch dict ('rgb_image', 'pc')
        -> (None, {'chamfer_loss'})."""
        with span('step'):
            t0 = time.perf_counter()
            with span('step.batch'):
                dev = self._to_device(self._rank_batch(
                    {k: batch[k] for k in ('rgb_image', 'pc')}))
            return self._optimizer_step(lambda: {
                'chamfer_loss': chamfer_loss(self.model(dev['rgb_image']),
                                             dev['pc'])}, t0)

    @torch.inference_mode()
    def predict(self, rgb_image: np.ndarray) -> np.ndarray:
        """(B, 4096, 3) f32 host clouds of B images, in eval mode."""
        self.model.eval()
        img = torch.as_tensor(np.asarray(rgb_image), dtype=torch.float32,
                              device=self.device)
        return self.model(img).float().cpu().numpy()

    def test(self, batch, eval_pred: bool = False):
        if isinstance(batch, dict):
            rgb, gt = batch['rgb_image'], batch.get('pc')
        else:
            rgb, gt = batch
        pred = self.predict(rgb)
        eval_score = self.eval(pred, np.asarray(gt)) if eval_pred else {}
        return pred, eval_score

    def eval(self, pred, gt) -> Dict[str, float]:
        if pred.shape[0] > 1:
            print('Evaluation of multiple predictions (batch_size > 1) '
                  'is not allowed.')
            return {}
        pred = np.asarray(pred)[0]
        gt = np.asarray(gt)[0] if gt.ndim == 3 else np.asarray(gt)
        if pred.shape[0] != gt.shape[0]:
            sample_pids = np.random.randint(gt.shape[0], size=pred.shape[0])
            gt = gt[sample_pids, :]
        return self.eval_fn(pred, gt)

    def save(self, batch, pred, fname: str):
        pred = np.asarray(pred)
        if pred.shape[0] > 1:
            print('Saving multiple predictions (batch_size > 1) '
                  'is not allowed.')
            return {}
        write_obj(fname + '_pred.obj', pred[0], [])


class LISTExecutor(BaseExecutor):
    """Stage-2 executor."""

    def __init__(self, config, model: torch.nn.Module, device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 decode_devices: Optional[Sequence] = None):
        super().__init__(config, model, device)
        self.compute_dtype = compute_dtype
        self.test_pointnum = config.test_pointnum
        self.sdf_scale = config.sdf_scale
        self.bb_min = config.bb_min
        self.bb_max = config.bb_max
        self.vox_res = config.vox_res
        self.eval_fn = eval_mesh
        self.decode_devices = self._split_devices(decode_devices)

    def _split_devices(self, devices) -> List[torch.device]:
        """The dense decode's devices: ``devices`` when given, else N from
        ``--mesh_shape`` (its ``query`` extent when 2-D and above 1, else
        its first), the first N cards, or the CPU N times; one device
        (this executor's) without either."""
        if devices is not None:
            return [resolve_device(d) for d in devices]
        shape = [int(s) for s in (getattr(self.config, 'mesh_shape', None)
                                  or ())]
        if len(shape) > 2:
            raise ValueError(f'--mesh_shape {shape}: 1 or 2 entries')
        n = shape[1] if len(shape) == 2 and shape[1] > 1 else \
            (shape[0] if shape else 1)
        if n <= 1:
            return [self.device]
        if self.device.type == 'cpu':
            return [self.device] * n
        if n > torch.cuda.device_count():
            raise ValueError(f'--mesh_shape {shape} needs {n} devices, have '
                             f'{torch.cuda.device_count()}')
        return [torch.device('cuda', i) for i in range(n)]

    def _dense_plan(self, ndev: int = 1, vox_res: Optional[int] = None):
        """(slab, use_pallas) of the dense decode of an R^3 grid (R:
        ``vox_res``, else the executor's); slab None means the chunked
        decoder.  The slab is the JAX package's: the whole grid in
        one slab for the fused head at R <= 128 on one device, else the
        largest of (64, 32, 16, 8, 4, 2) (above R = 192: (8, 4, 2)) that
        divides R into a slab count divisible by the ``ndev`` devices of a
        split decode.

        The head follows ``--use_pallas`` (0, 1 or 2) on the card and is
        always 0 on the CPU, as the JAX package's is.  Its auto choice
        (-1) differs: the JAX package takes the XLA head for multi-slab
        grids after TPU measurements, but on the card that head (the
        f32-upcast plain function) is 2.4x slower than K1, so -1 is K1 at
        every R (PERF.md).  K1 takes any query count, so the JAX package's
        Pallas tile gate is not needed."""
        R = self.vox_res if vox_res is None else int(vox_res)
        cfg_up = int(getattr(self.config, 'use_pallas', -1))
        on_card = self.device.type == 'cuda'
        head = (2 if cfg_up == -1 else cfg_up) if on_card else 0
        if on_card and ndev == 1 and R <= 128 and head == 2:
            return R, 2
        pref = (64, 32, 16, 8, 4, 2) if R <= 192 else (8, 4, 2)
        slab = next((s for s in pref if R % s == 0
                     and (R // s) % ndev == 0), None)
        if slab is None:
            return None, 0
        return slab, head

    def _wire(self, fetch_dtype, fetch_mode):
        if fetch_dtype is None:
            fetch_dtype = getattr(self.config, 'fetch_dtype', 'float32')
        if fetch_mode is None:
            fetch_mode = getattr(self.config, 'fetch_mode', 'grid')
        return fetch_dtype, fetch_mode

    def _decode(self, enc, slab, use_pallas) -> torch.Tensor:
        """The dense (R, R, R) raw SDF of one image's encoding, over
        ``decode_devices``: device i of N decodes x rows
        [i R / N, (i + 1) R / N) from its copy of the features and the
        decoder, and the ranges are concatenated on this executor's
        device.  Everything is queued from this thread, the copies first,
        then the devices' slabs in turns (slab k on every device, then
        slab k + 1), each with its device current.  Once a (device, R,
        slab, head) has been decoded its constants are on the card
        (``ops/consts.py``) and nothing waits for a card but the launch
        queue, which the turns keep from holding one card's slabs while
        the others idle: the cards run at the same time (the counterpart
        of the JAX package's one ``shard_map`` dispatch over the
        slabs)."""
        devs = self.decode_devices
        rows = self.vox_res // len(devs)
        slabs = [dense_grid_slabs(
            self.model.sdf_decoder if d == self.device
            else copy.deepcopy(self.model.sdf_decoder).to(d),
            [f.to(d) for f in enc['vox_feat']],
            [f.to(d) for f in enc['feat_l2']], enc['trans_mat'].to(d),
            self.vox_res, slab=slab, compute_dtype=self.compute_dtype,
            bb_min=self.bb_min, bb_max=self.bb_max, use_pallas=use_pallas,
            x_range=(i * rows, (i + 1) * rows)) for i, d in enumerate(devs)]
        parts = [[] for _ in devs]
        for _ in range(rows // slab):
            for i, d in enumerate(devs):
                with (torch.cuda.device(d) if d.type == 'cuda'
                      else contextlib.nullcontext()):
                    parts[i].append(next(slabs[i]))
        return torch.cat([torch.cat(p).to(self.device) for p in parts])

    def _finish(self, grid, fetch_dtype, fetch_mode):
        """The raw grid -> the wire's: the ``sdf_scale`` divide, the wire
        cast and in band mode ``band_encode`` (the span
        ``request.finish``)."""
        with span('request.finish', self.device):
            wire = (torch.bfloat16 if fetch_dtype == 'bfloat16'
                    else torch.float32)
            grid = (grid / self.sdf_scale).to(wire)
            if fetch_mode == 'band':
                return BandGrid(band_encode(grid), grid, self.vox_res,
                                fetch_dtype)
            return grid

    @torch.inference_mode()
    def predict_grid(self, rgb_image: np.ndarray,
                     trans_mat: Optional[np.ndarray] = None,
                     fast: Optional[bool] = None,
                     device_out: bool = False,
                     fetch_dtype: Optional[str] = None,
                     fetch_mode: Optional[str] = None):
        """Dense (R, R, R) SDF field for one image: the f32 host grid, or
        with ``device_out`` the device result for ``fetch_grid_f32`` (a
        ``BandGrid`` in band mode, else the wire-dtype grid).  Band applies
        to the dense path only: the chunked fallback returns the grid.

        ``timings`` gets ``encode_s`` and ``decode_s`` (the fetch
        included) from the host clock around synchronized phases; with
        ``device_out`` on the card the call returns without waiting for
        the device, its result carries the CUDA events around the encode
        and the decode (``utils.spans.DeviceSpans``), and the two times
        reach ``timings`` when the result is fetched.

        The call is the span ``request.launch`` (this thread's time), with
        the children ``request.upload`` (the image's copy to the device,
        which waits for the work queued before it), ``request.encode``,
        the decode's phases (``ops/dense_grid.py``) and
        ``request.finish``; a device result
        carries it as ``request_span``, the parent of its fetch's
        ``request.fetch``."""
        with span('request.launch') as req:
            fetch_dtype, fetch_mode = self._wire(fetch_dtype, fetch_mode)
            self.model.eval()
            with span('request.upload'):
                img = torch.as_tensor(np.asarray(rgb_image),
                                      dtype=torch.float32, device=self.device)
                tm = (None if trans_mat is None else torch.as_tensor(
                    np.asarray(trans_mat), dtype=torch.float32,
                    device=self.device))
            if fast is None:
                fast = bool(getattr(self.config, 'fast_grid', 1)) \
                    and img.shape[0] == 1
            slab, use_pallas = self._dense_plan(len(self.decode_devices))
            spans = self._spans(device_out)
            t0 = time.perf_counter()
            with span('request.encode'):
                enc = self.model.encode(img, tm)
            if spans is None:
                self._sync()
            else:
                spans.mark()
            t1 = time.perf_counter()
            if fast and slab is not None:
                out = self._finish(self._decode(enc, slab, use_pallas),
                                   fetch_dtype, fetch_mode)
            else:
                out = self._finish(self._chunked_decode(enc), fetch_dtype,
                                   'grid')
            if device_out:
                out.request_span = req
            if spans is not None:
                return mark_ready(out, spans)
            if not device_out:
                out = fetch_grid_f32(out)
            self._sync()
            self.timings.update(encode_s=t1 - t0,
                                decode_s=time.perf_counter() - t1)
            return out

    def _spans(self, device_out: bool) -> Optional[DeviceSpans]:
        """Under ``device_out`` on the card: the call's CUDA events, its
        start marked, and its stale times dropped from ``timings`` (the
        fetch writes them); else None (synchronized host clock)."""
        if not (device_out and self.device.type == 'cuda'):
            return None
        self.timings.pop('encode_s', None)
        self.timings.pop('decode_s', None)
        spans = DeviceSpans(self.device, self.timings)
        spans.mark()
        return spans

    @torch.inference_mode()
    def predict_grid_batch(self, rgb_images: np.ndarray,
                           trans_mats: Optional[np.ndarray] = None,
                           device_out: bool = False,
                           fetch_dtype: Optional[str] = None,
                           fetch_mode: Optional[str] = None):
        """Dense SDF fields for B images with one batched encoder pass,
        then one decode per image: a list of B device results with
        ``device_out`` (each fetched on its own), else a (B, R, R, R) f32
        host array.  ``timings`` holds the batch's ``encode_s`` and the
        summed ``decode_s`` (with ``device_out`` on the card from one
        ``DeviceSpans`` that the B results share, as in ``predict_grid``)."""
        fetch_dtype, fetch_mode = self._wire(fetch_dtype, fetch_mode)
        slab, use_pallas = self._dense_plan(len(self.decode_devices))
        if not (bool(getattr(self.config, 'fast_grid', 1))
                and slab is not None):
            grids = [self.predict_grid(
                rgb_images[i:i + 1],
                None if trans_mats is None else trans_mats[i:i + 1],
                device_out=True, fetch_dtype=fetch_dtype,
                fetch_mode=fetch_mode) for i in range(len(rgb_images))]
        else:
            self.model.eval()
            img = torch.as_tensor(np.asarray(rgb_images),
                                  dtype=torch.float32, device=self.device)
            tm = (None if trans_mats is None else torch.as_tensor(
                np.asarray(trans_mats), dtype=torch.float32,
                device=self.device))
            spans = self._spans(device_out)
            t0 = time.perf_counter()
            enc = self.model.encode(img, tm)
            if spans is None:
                self._sync()
            else:
                spans.mark()
            t1 = time.perf_counter()
            grids = []
            for i in range(img.shape[0]):
                g = self._finish(self._decode(
                    {'vox_feat': [f[i:i + 1] for f in enc['vox_feat']],
                     'feat_l2': [f[i:i + 1] for f in enc['feat_l2']],
                     'trans_mat': enc['trans_mat'][i:i + 1]}, slab,
                    use_pallas), fetch_dtype, fetch_mode)
                grids.append(g if spans is None else mark_ready(g, spans))
            if spans is None:
                self._sync()
                self.timings.update(encode_s=t1 - t0,
                                    decode_s=time.perf_counter() - t1)
        if device_out:
            return grids
        return np.stack([fetch_grid_f32(g) for g in grids])

    def _chunked_decode(self, enc) -> torch.Tensor:
        """The general gather decoder over grid chunks of test_pointnum."""
        pts = create_grid_points_from_bounds(self.bb_min, self.bb_max,
                                             self.vox_res)
        pts = torch.as_tensor(pts.astype(np.float32)[None],
                              device=self.device)
        vals = [self.model.decode_sdf(pts[:, s:s + self.test_pointnum], enc)
                for s in range(0, pts.shape[1], self.test_pointnum)]
        return torch.cat(vals, dim=1).reshape((self.vox_res,) * 3)

    # -- training ------------------------------------------------------------
    def calc_loss(self, pred, gt) -> Dict[str, torch.Tensor]:
        occ_pred, sdf_pred = pred
        occ_gt, sdf_gt = gt
        losses = {'occ_loss': occupancy_loss(occ_pred, occ_gt)}
        losses.update(sdf_loss(sdf_pred, sdf_gt, self.sdf_scale))
        return losses

    def _train_keys(self, batch):
        keep = {k: batch[k] for k in ('rgb_image', 'points', 'values', 'occ')}
        if 'transmat' in batch:
            keep['transmat'] = batch['transmat']
        # exactly-binary occupancy rides host -> device as uint8 (4x fewer
        # bytes); the step casts it back to f32, bit-exact for 0/1
        # targets.  Soft occupancies pass through.
        occ = keep.get('occ')
        if isinstance(occ, np.ndarray) and occ.dtype == np.float32 \
                and ((occ == 0) | (occ == 1)).all():
            keep['occ'] = occ.astype(np.uint8)
        return keep

    def train(self, batch, calc_loss: bool = True):
        """One optimizer step on a host batch dict ('rgb_image', 'points',
        'values', 'occ', optional 'transmat') -> (None, losses).  The
        floating-point inputs take the parameters' dtype; the occupancy
        target is f32, as the occupancy loss computes in f32 (a soft f32
        target goes through f32 or f64 parameters' dtype exactly).  The
        batch's upload (``_to_device``) and the closing synchronization
        are the step's only waits on the card.  The call is the span
        ``step``, the batch's host work (``_rank_batch``, ``_train_keys``,
        ``_to_device``) its child ``step.batch``."""
        with span('step'):
            with span('step.batch'):
                keep = self._rank_batch(self._train_keys(batch))
                t0 = time.perf_counter()
                dev = self._to_device(keep)
                # uint8, or f32 through the dtype
                occ_gt = dev.pop('occ').float()

            def losses():
                pred = self.model(dev['rgb_image'], dev['points'],
                                  dev.get('transmat'))
                return self.calc_loss(pred, (occ_gt, dev['values']))

            return self._optimizer_step(losses, t0)

    def test(self, batch, eval_pred: bool = False):
        img = batch['rgb_image']
        mesh_gt = batch.get('gt_mesh')
        pred_values = self.predict_grid(img, batch.get('transmat'))
        pred_mesh = generate_mesh(pred_values, self.bb_min, self.bb_max,
                                  as_trimesh_obj=True,
                                  renorm=getattr(self.config, 'mesh_renorm',
                                                 'reference'))
        eval_score = (self.eval(pred_mesh, mesh_gt)
                      if eval_pred and mesh_gt is not None else {})
        return [pred_mesh, pred_values], eval_score

    def eval(self, pred, gt) -> Dict[str, float]:
        return self.eval_fn(pred, gt, self.bb_min, self.bb_max)

    def save(self, batch, pred, fname: str):
        pred[0].export(fname + '_pred.obj')
