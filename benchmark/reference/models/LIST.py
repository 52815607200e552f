"""LIST (stage 2): the reference of a ``"model": "LIST"`` configuration.

Training and the mesh's grid are ``reference/model.py``'s, the leaves
``reference/weights.py``'s, the batches ``traffic_gen.py``'s and the
FLOPs ``counts.py``'s.

Random weights give no surface, so ``prepare_mesh`` fits them to the
traffic as a trained model's are: every BatchNorm's running statistics
become those of the encoder over the first ``fit_images`` images in
training mode; then ``fc_out`` (the decoder's last layer, 256 -> 1) is
solved by ridge least squares so that the decoder gives those images'
analytic SDF at their training queries and at the voxel grid's points at
``FIT_STRIDE``.  The surface is then as thin as a trained model's, and
the band wire carries it.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from benchmark import counts, traffic_gen
from benchmark.reference import model, weights

# fc_out's fit: the voxel grid's points at this stride, and this share of
# the Gram matrix's mean diagonal added to it (1e-8 to 1e-2 read alike)
FIT_STRIDE = 4
FIT_RIDGE = 1e-4

spec = weights.list_spec
batches = traffic_gen.list_batches
losses = model.list_losses
train_step_flops = counts.list_train_step_flops
sdf_grid = model.sdf_grid
mesh_flops = counts.mesh_flops


def prepare_mesh(cfg: Dict, tr: Dict, w: Dict[str, torch.Tensor],
                 imgs: np.ndarray, shapes, seed: int, device,
                 log: Callable[[str], None]) -> Dict[str, torch.Tensor]:
    """Set ``w``'s running statistics and ``fc_out`` in place (module
    docstring); -> those leaves, on the host."""
    n = tr['fit_images']
    x = torch.as_tensor(imgs[:n], device=device)
    pts, sdf = traffic_gen.fit_targets(cfg, shapes, n, FIT_STRIDE, seed)
    with model.precision('f32'):
        for name, (mean, var) in model.batch_statistics(w, cfg, x).items():
            w[f'{name}.running_mean'].copy_(mean)
            w[f'{name}.running_var'].copy_(var)
        h = model.fit_features(w, cfg, x, pts)
    a = torch.cat([h.reshape(-1, h.shape[-1]),
                   torch.ones_like(h[..., :1]).reshape(-1, 1)], 1).double()
    del h
    y = sdf.reshape(-1).double() * cfg['sdf_scale']
    gram = a.T @ a
    gram.diagonal().add_(FIT_RIDGE * gram.diagonal().mean())
    sol = torch.linalg.solve(gram, a.T @ y)
    w['sdf_decoder.fc_out.weight'].copy_(sol[None, :-1])
    w['sdf_decoder.fc_out.bias'].copy_(sol[-1:])
    log('fc_out weight norm '
        f'{float(w["sdf_decoder.fc_out.weight"].norm()):.6g}')
    return {k: t.detach().cpu().clone() for k, t in w.items()
            if k.endswith(('running_mean', 'running_var'))
            or k.startswith('sdf_decoder.fc_out.')}
