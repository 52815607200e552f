"""A configuration's plain reference, found by the name of its model.

``find(cfg)`` imports ``benchmark.reference.models.<cfg['model']>``: one
module a model, in plain PyTorch, importing nothing of the program.  The
name is the one the program's registry resolves to the model and its
executor (``benchmark/program.py``).  A module supplies:

- ``spec(cfg)``: the model's leaves (``weights.Leaf``: state_dict name,
  shape, kind, scale), which ``weights.make`` fills from a seed;
- ``batches(cfg, traffic, seed, device)``: a training cell's distinct
  host batches, as the executor's ``train`` takes them;
- ``losses(P, cfg, batch, chunk, low=False)``: one training forward and
  backward of a device batch, the gradients into ``P``'s leaves -> {name:
  loss};
- ``train_step_flops(cfg)``: the model FLOPs of one step
  (``metrics/train_mfu_pct.py``);

and for a configuration that serves meshes:

- ``prepare_mesh(cfg, traffic, w, imgs, shapes, seed, device, log)``: fit
  the weights ``w`` to the traffic's images in place, as a trained
  model's are -> the leaves it set, on the host;
- ``sdf_grid(P, cfg, img, resolution, low=False)``: one image's raw SDF
  on the resolution^3 grid, in eval mode;
- ``mesh_flops(cfg, resolution)``: the model FLOPs of one mesh
  (``metrics/mesh_mfu_pct.py``).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def find(cfg: Dict) -> ModuleType:
    return importlib.import_module(f'{__name__}.{cfg["model"]}')
