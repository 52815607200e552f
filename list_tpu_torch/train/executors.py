"""Stage-2 executor (counterpart of
``list_tpu/train/executors.py::LISTExecutor``).

``LISTExecutor(config, model, device=None)`` owns the model on its device
(``cuda`` unless the caller passes ``device='cpu'``) in eval mode.

- ``predict_grid`` runs encode + dense-grid decode + the ``sdf_scale``
  divide + the ``--fetch_dtype`` cast (+ the ``--fetch_mode band`` encode)
  on the device and returns the (R, R, R) f32 host grid, or with
  ``device_out`` the device result (a ``BandGrid`` in band mode) for a
  fetch worker; ``predict_grid_batch`` encodes B images in one pass and
  decodes each; ``test`` adds marching cubes and, with ``eval_pred``, the
  mesh metrics.
- ``train(batch)`` runs one optimizer step (forward in train mode, the
  occupancy and SDF losses, backward, Adam) on a host batch dict and
  returns ``(None, losses)``; ``train_multi(batches)`` runs one step per
  batch and returns (K,) losses.  The model is in train mode only inside
  a step.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from list_tpu_torch.device import resolve_device
from list_tpu_torch.eval.metrics import eval_mesh
from list_tpu_torch.ops.band import BandGrid, band_encode, fetch_grid_f32
from list_tpu_torch.ops.dense_grid import dense_grid_sdf
from list_tpu_torch.ops.grid import create_grid_points_from_bounds
from list_tpu_torch.ops.losses import occupancy_loss, sdf_loss
from list_tpu_torch.train.state import make_optimizer
from list_tpu_torch.utils.meshing import generate_mesh


def total_loss(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of all entries whose key does not contain 'ignore'."""
    total = 0.0
    for k, v in loss_dict.items():
        if 'ignore' not in k:
            total = total + v
    return total


class LISTExecutor:
    def __init__(self, config, model: torch.nn.Module, device=None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.test_pointnum = config.test_pointnum
        self.sdf_scale = config.sdf_scale
        self.bb_min = config.bb_min
        self.bb_max = config.bb_max
        self.vox_res = config.vox_res
        self.eval_fn = eval_mesh
        self.timings: Dict[str, float] = {}
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _dense_plan(self):
        """(slab, use_pallas) of the dense decode; slab None means the
        chunked decoder.  The slab is the JAX package's: the whole grid in
        one slab for the fused head at R <= 128, else the largest of
        (64, 32, 16, 8, 4, 2) (above R = 192: (8, 4, 2)) dividing R.

        The head follows ``--use_pallas`` (0, 1 or 2) on the card and is
        always 0 on the CPU, as the JAX package's is.  Its auto choice
        (-1) differs: the JAX package takes the XLA head for multi-slab
        grids after TPU measurements, but on the card that head (the
        f32-upcast plain function) is 2.4x slower than K1, so -1 is K1 at
        every R (PERF.md).  K1 takes any query count, so the JAX package's
        Pallas tile gate is not needed."""
        R = self.vox_res
        cfg_up = int(getattr(self.config, 'use_pallas', -1))
        on_card = self.device.type == 'cuda'
        head = (2 if cfg_up == -1 else cfg_up) if on_card else 0
        if on_card and R <= 128 and head == 2:
            return R, 2
        pref = (64, 32, 16, 8, 4, 2) if R <= 192 else (8, 4, 2)
        slab = next((s for s in pref if R % s == 0), None)
        if slab is None:
            return None, 0
        return slab, head

    def _wire(self, fetch_dtype, fetch_mode):
        if fetch_dtype is None:
            fetch_dtype = getattr(self.config, 'fetch_dtype', 'float32')
        if fetch_mode is None:
            fetch_mode = getattr(self.config, 'fetch_mode', 'grid')
        return fetch_dtype, fetch_mode

    def _dense_finish(self, vox_feat, feat_l2, trans_mat, slab, use_pallas,
                      fetch_dtype, fetch_mode):
        """Dense decode + ``sdf_scale`` divide + wire cast (+ band encode)
        of one image's encoding, on the device."""
        grid = dense_grid_sdf(self.model.sdf_decoder, vox_feat, feat_l2,
                              trans_mat, self.vox_res, slab=slab,
                              compute_dtype=self.compute_dtype,
                              bb_min=self.bb_min, bb_max=self.bb_max,
                              use_pallas=use_pallas)
        return self._finish(grid, fetch_dtype, fetch_mode)

    def _finish(self, grid, fetch_dtype, fetch_mode):
        wire = torch.bfloat16 if fetch_dtype == 'bfloat16' else torch.float32
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
        to the dense path only: the chunked fallback returns the grid."""
        fetch_dtype, fetch_mode = self._wire(fetch_dtype, fetch_mode)
        self.model.eval()
        img = torch.as_tensor(np.asarray(rgb_image), dtype=torch.float32,
                              device=self.device)
        tm = (None if trans_mat is None else torch.as_tensor(
            np.asarray(trans_mat), dtype=torch.float32, device=self.device))
        if fast is None:
            fast = bool(getattr(self.config, 'fast_grid', 1)) \
                and img.shape[0] == 1
        slab, use_pallas = self._dense_plan()
        t0 = time.perf_counter()
        enc = self.model.encode(img, tm)
        self._sync()
        t1 = time.perf_counter()
        if fast and slab is not None:
            out = self._dense_finish(enc['vox_feat'], enc['feat_l2'],
                                     enc['trans_mat'], slab, use_pallas,
                                     fetch_dtype, fetch_mode)
        else:
            out = self._finish(self._chunked_decode(enc), fetch_dtype,
                               'grid')
        if not device_out:
            out = fetch_grid_f32(out)
        self._sync()
        self.timings.update(encode_s=t1 - t0,
                            decode_s=time.perf_counter() - t1)
        return out

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
        summed ``decode_s``."""
        fetch_dtype, fetch_mode = self._wire(fetch_dtype, fetch_mode)
        slab, use_pallas = self._dense_plan()
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
            t0 = time.perf_counter()
            enc = self.model.encode(img, tm)
            self._sync()
            t1 = time.perf_counter()
            grids = [self._dense_finish(
                [f[i:i + 1] for f in enc['vox_feat']],
                [f[i:i + 1] for f in enc['feat_l2']],
                enc['trans_mat'][i:i + 1], slab, use_pallas, fetch_dtype,
                fetch_mode) for i in range(img.shape[0])]
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
    def init_optimizer(self, frozen_prefixes: Sequence[str] = ()
                       ) -> torch.optim.Adam:
        c = self.config
        self.optimizer = make_optimizer(
            self.model.named_parameters(), c.lr, c.beta1,
            weight_decay=c.weight_decay, frozen_prefixes=frozen_prefixes)
        return self.optimizer

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
        target is f32, as the occupancy loss computes in f32."""
        if self.optimizer is None:
            self.init_optimizer()
        keep = self._train_keys(batch)
        t0 = time.perf_counter()
        dtype = next(self.model.parameters()).dtype
        dev = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in keep.items()}
        occ_gt = dev.pop('occ').float()  # uint8 wire or soft f32
        dev = {k: v.to(dtype) for k, v in dev.items()}
        self.model.train()
        try:
            self.optimizer.zero_grad(set_to_none=True)
            pred = self.model(dev['rgb_image'], dev['points'],
                              dev.get('transmat'))
            losses = self.calc_loss(pred, (occ_gt, dev['values']))
            total_loss(losses).backward()
            self.optimizer.step()
        finally:
            self.model.eval()
        self.step += 1
        self._sync()
        self.timings['step_s'] = time.perf_counter() - t0
        return None, {k: v.detach() for k, v in losses.items()}

    def train_multi(self, batches):
        """One step per batch, in order -> (None, {key: (K,) losses})."""
        steps = [self.train(b)[1] for b in batches]
        return None, {k: torch.stack([s[k] for s in steps])
                      for k in steps[0]}

    def test(self, batch, eval_pred: bool = False):
        img = batch['rgb_image']
        mesh_gt = batch.get('gt_mesh')
        pred_values = self.predict_grid(img, batch.get('transmat'))
        t0 = time.perf_counter()
        pred_mesh = generate_mesh(pred_values, self.bb_min, self.bb_max,
                                  as_trimesh_obj=True,
                                  renorm=getattr(self.config, 'mesh_renorm',
                                                 'reference'))
        t1 = time.perf_counter()
        eval_score = (self.eval(pred_mesh, mesh_gt)
                      if eval_pred and mesh_gt is not None else {})
        self.timings.update(mesh_s=t1 - t0,
                            eval_s=time.perf_counter() - t1)
        return [pred_mesh, pred_values], eval_score

    def eval(self, pred, gt) -> Dict[str, float]:
        return self.eval_fn(pred, gt, self.bb_min, self.bb_max)

    def save(self, batch, pred, fname: str):
        pred[0].export(fname + '_pred.obj')
