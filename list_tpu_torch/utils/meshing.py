"""SDF-grid -> mesh extraction with reference semantics.

``generate_mesh`` (reference: utils.py:172-182): run marching cubes on
``-1.0 * grid`` at threshold 0, then renormalize vertices with the
reference's *global scalar* min/max (NOT per-axis, NOT grid coords):
``v = (v - v.min()) / v.max() * (bb_max - bb_min) + bb_min``.  This quirk is
part of the behavioral spec (SURVEY.md §3.6) and is preserved; pass
``renorm='exact'`` for the geometrically exact grid-coordinate mapping.

``generate_scaled_mesh`` (reference: utils.py:158-169): step-scaled variant
with the [2,1,0] axis swap.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from list_tpu_torch import native
from list_tpu_torch.utils.meshio import Mesh
from list_tpu_torch.utils.spans import span


def generate_mesh(gridvalues: np.ndarray, bb_min: float, bb_max: float,
                  threshold: float = 0.0, as_trimesh_obj: bool = False,
                  renorm: str = 'reference'
                  ) -> Union[Mesh, Tuple[np.ndarray, np.ndarray]]:
    """The mesh of ``gridvalues`` (module docstring); the span
    ``mesh.generate``."""
    with span('mesh.generate'):
        vertices, triangles = native.marching_cubes(-1.0 * gridvalues,
                                                    threshold)
        if len(vertices) > 10:
            if renorm == 'reference':
                # quirky global-scalar renorm (utils.py:176-177)
                vertices = (vertices - vertices.min()) / vertices.max()
                vertices = vertices * (bb_max - bb_min) + bb_min
            else:
                res = gridvalues.shape[0]
                vertices = vertices / (res - 1) * (bb_max - bb_min) + bb_min
    if as_trimesh_obj:
        return Mesh(vertices, triangles)
    return vertices, triangles


def generate_scaled_mesh(grid: np.ndarray, threshold: float, bb_min: float,
                         bb_max: float, res: int,
                         as_trimesh_obj: bool = False):
    vertices, triangles = native.marching_cubes(-1.0 * grid, threshold)
    step = (bb_max - bb_min) / (res - 1)
    vertices = vertices * step
    vertices = vertices + np.array([bb_min, bb_min, bb_min])
    vertices = vertices[:, [2, 1, 0]]
    if as_trimesh_obj:
        return Mesh(vertices, triangles)
    return vertices, triangles


def render_grid_occupancy(fname: str, gridvalues: np.ndarray,
                          threshold: float = 0) -> None:
    """Render the occupancy field to 3 axis-projection PNGs
    (reference: utils.py:143-155)."""
    import cv2
    signmat = np.sign(gridvalues - threshold)
    base = fname[:-4]
    for axis in range(3):
        img = np.clip((np.amax(signmat, axis=axis)
                       - np.amin(signmat, axis=axis)) * 256, 0,
                      255).astype(np.uint8)
        cv2.imwrite(f'{base}_{axis + 1}.png', img)


def save_volume(fname: str, volume: np.ndarray, dim_h: int = 128,
                dim_w: int = 128, voxel_size: float = 1.0 / 128) -> None:
    """Dump occupied voxel centers as OBJ points (reference: utils.py:205-219)."""
    occ = np.argwhere(volume > 0)
    with open(fname, 'w') as fp:
        for xx, yy, zz in occ:
            fp.write('v %f %f %f\n' % ((xx - dim_w / 2 + 0.5) * voxel_size,
                                       (yy - dim_h / 2 + 0.5) * voxel_size,
                                       (zz - dim_w / 2 + 0.5) * voxel_size))
