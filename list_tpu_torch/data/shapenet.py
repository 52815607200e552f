"""The ShapeNet stage-2 dataset, test side (counterpart of ``IM2SDF`` in
``list_tpu/data/shapenet.py``, copied apart from imports).

Same on-disk layout as the reference:

- images: ``<image_dir>/<cat>/<shape>/easy/NN.png``;
- h5: ``<h5_dir>/<cat>/<shape>/sampled_points.h5`` (its presence puts a
  shape on the list);
- meshes: ``<mesh_dir>/<cat>/<shape>/isosurf_scaled.obj``;
- splits: ``<split_dir>/<cat>_{train,test}.lst``.

``get_testdata`` serves the test sweep.  The training reader (h5 queries,
occupancies, augmentations) is not ported yet.  PIL is imported where an
image is read.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from list_tpu_torch.data.transforms import to_float
from list_tpu_torch.utils.meshio import load_mesh


def read_shape_ids(filename: str) -> List[str]:
    with open(filename) as f:
        return [l.strip('\n') for l in f.readlines()]


class IM2SDF:
    """Stage-2 dataset: the split file's shapes that have an h5 file.
    Train split capped at 2,000 shapes/class (Datasets.py:182-183)."""

    def __init__(self, config, status: str):
        self.config = config
        self.status = status
        self.catlist = config.catlist
        self.datalist: List[Dict] = []
        for cat_id in self.catlist:
            fn = self._split_file(cat_id)
            if not os.path.exists(fn):
                continue
            shape_ids = read_shape_ids(fn)
            if status == 'train' and len(shape_ids) > 2000:
                shape_ids = shape_ids[:2000]
            for shape_id in shape_ids:
                rgb_fn = os.path.join(config.image_dir, cat_id, shape_id,
                                      'easy/')
                h5_fn = os.path.join(config.h5_dir, cat_id, shape_id,
                                     'sampled_points.h5')
                if os.path.exists(h5_fn):
                    self.datalist.append({'rgba_dir': rgb_fn, 'h5_fn': h5_fn,
                                          'cat_id': cat_id,
                                          'shape_id': shape_id})
        print(f'{type(self).__name__}: loaded {len(self.datalist)} '
              f'{status} shapes')

    def __len__(self):
        return len(self.datalist)

    def _split_file(self, cat_id: str) -> str:
        split_dir = getattr(self.config, 'split_dir', './data/DISN_split')
        return os.path.join(split_dir, f'{cat_id}_{self.status}.lst')

    def read_rgb(self, img_dir: str, cam_id) -> np.ndarray:
        from PIL import Image
        img_fn = os.path.join(img_dir, str(cam_id).zfill(2) + '.png')
        return np.asarray(Image.open(img_fn).convert('RGB'))

    def get_testdata(self, cat_id: str, shape_id: str, cam_id) -> Dict:
        rgb_fn = os.path.join(self.config.image_dir, cat_id, shape_id, 'easy/')
        mesh_fn = os.path.join(self.config.mesh_dir, cat_id, shape_id,
                               'isosurf_scaled.obj')
        rgb = self.read_rgb(rgb_fn, cam_id)
        gt_mesh = load_mesh(mesh_fn)
        return {'rgb_image': to_float(rgb)[None], 'gt_mesh': gt_mesh,
                'cat_id': cat_id, 'shape_id': shape_id}
