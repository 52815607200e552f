"""ShapeNet datasets: IM2PointFarthest (stage 1) and IM2SDF (stage 2),
copied from ``list_tpu/data/shapenet.py`` apart from imports: PIL is
imported where an image is read, HDF5 files go through ``utils/h5.py``
(the port does not need h5py), and ``quantize_occupancy`` is the one
in ``data/synthetic.py``.

Same on-disk artifact formats as the reference so preprocessed ShapeNet data
is reusable unchanged (datasets/Datasets.py:56-304):
- images:  <image_dir>/<cat>/<shape>/easy/NN.png
- h5:      <h5_dir>/<cat>/<shape>/farthest_pointclouds.h5 ['points_5000']
           <h5_dir>/<cat>/<shape>/sampled_points.h5
             ['grid_points', 'query_points_sigma_<s>' (N,4)]
           <h5_dir>/<cat>/<shape>/occupancies.h5
             ['res_<R>_points_<P>'] (uint8 flat occupancy)
- splits:  data/DISN_split/<cat>_{train,test}.lst + testlist_all.lst

Behavioral deltas (deliberate, documented in SURVEY.md §3.6/§7):
- The stage-1 dataset returns a dict {'rgb_image','pc'} — the reference
  returns a tuple but its executor reads dict keys (executors.py:42-45);
  we normalize to the dict path.
- Occupancy caching is thread-safe and can be precomputed via
  ``ensure_occupancies()`` — the reference lazily appends to a shared h5
  from 4 DataLoader workers during training (a write race).
- All randomness uses a seeded np.random.Generator per epoch/index instead
  of the reference's mixed seeded-torch + unseeded-random.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from list_tpu_torch.data.synthetic import quantize_occupancy
from list_tpu_torch.data.transforms import ImageTransform, to_float
from list_tpu_torch.utils import h5
from list_tpu_torch.utils.meshio import load_mesh

_h5_lock = threading.Lock()


def read_shape_ids(filename: str) -> List[str]:
    with open(filename) as f:
        return [l.strip('\n') for l in f.readlines()]


class ShapeNetBase:
    def __init__(self, config, status: str):
        self.config = config
        self.status = status
        self.catlist = config.catlist
        self.viewnum = config.viewnum
        self.num_points = config.sample_point_density
        self.coarse_points = config.coarse_point_density
        self.vox_res = config.vox_res
        self.rng = np.random.RandomState(333)
        self._gen = np.random.default_rng(getattr(config, 'seed', 333))
        is_train = status == 'train'
        self.transforms = ImageTransform(
            random_h_flip=config.random_h_flip and is_train,
            color_jitter=config.color_jitter and is_train,
            normalize=config.normalize)
        self.datalist: List[Dict] = []

    def __len__(self):
        return len(self.datalist)

    def _split_file(self, cat_id: str) -> str:
        split_dir = getattr(self.config, 'split_dir', './data/DISN_split')
        return os.path.join(split_dir, f'{cat_id}_{self.status}.lst')

    def read_rgb(self, img_dir: str, cam_id) -> np.ndarray:
        from PIL import Image
        img_fn = os.path.join(img_dir, str(cam_id).zfill(2) + '.png')
        return np.asarray(Image.open(img_fn).convert('RGB'))


class IM2PointFarthest(ShapeNetBase):
    """Stage-1: (image, FPS-5000 GT cloud).  Train split capped at 2,500
    shapes/class (Datasets.py:74-75)."""

    def __init__(self, config, status: str):
        super().__init__(config, status)
        for cat_id in self.catlist:
            fn = self._split_file(cat_id)
            if not os.path.exists(fn):
                continue
            shape_ids = read_shape_ids(fn)
            if status == 'train' and len(shape_ids) > 2500:
                shape_ids = shape_ids[:2500]
            for shape_id in shape_ids:
                rgb_fn = os.path.join(config.image_dir, cat_id, shape_id,
                                      'easy/')
                h5_fn = os.path.join(config.h5_dir, cat_id, shape_id,
                                     'farthest_pointclouds.h5')
                if os.path.exists(h5_fn) and os.path.exists(rgb_fn):
                    self.datalist.append({'rgba_dir': rgb_fn, 'h5_fn': h5_fn,
                                          'cat_id': cat_id,
                                          'shape_id': shape_id})
        print(f'{type(self).__name__}: loaded {len(self.datalist)} '
              f'{status} shapes')

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        data = self.datalist[index]
        cam_id = int(self._gen.integers(0, self.viewnum))
        rgb = self.read_rgb(data['rgba_dir'], cam_id)
        with _h5_lock, h5.File(data['h5_fn'], 'r') as f:
            pc = f['points_5000'][:]
        return {'rgb_image': self.transforms(rgb, self._gen),
                'pc': pc.astype(np.float32)}

    def get_testdata(self, cat_id: str, shape_id: str, cam_id):
        rgb_fn = os.path.join(self.config.image_dir, cat_id, shape_id, 'easy/')
        h5_fn = os.path.join(self.config.h5_dir, cat_id, shape_id,
                             'farthest_pointclouds.h5')
        rgb = self.read_rgb(rgb_fn, cam_id)
        with h5.File(h5_fn, 'r') as f:
            pc = f['points_5000'][:]
        return (to_float(rgb)[None], pc.astype(np.float32)[None])


class IM2SDF(ShapeNetBase):
    """Stage-2: (image, mixed-sigma SDF queries, FPS cloud occupancy).
    Train split capped at 2,000 shapes/class (Datasets.py:182-183)."""

    def __init__(self, config, status: str):
        super().__init__(config, status)
        self.sampling_mode = config.sampling_mode
        self.query_samples = np.rint(np.asarray(config.sample_distribution)
                                     * config.sample_point_density
                                     ).astype(np.uint32)
        self.sigmas = config.sigmas
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

    def _occ_key(self) -> str:
        return f'res_{self.vox_res}_points_{self.coarse_points}'

    def _load_occ(self, h5_fn: str, pc: np.ndarray) -> np.ndarray:
        occ_file = os.path.join(os.path.dirname(h5_fn), 'occupancies.h5')
        key = self._occ_key()
        with _h5_lock:
            with h5.File(occ_file, 'a') as f:
                if key not in f.keys():
                    occ = quantize_occupancy(pc, self.config.bb_min,
                                             self.config.bb_max, self.vox_res)
                    f.create_dataset(key, data=occ, compression='gzip')
                else:
                    occ = f[key][:]
        return occ.reshape((self.vox_res,) * 3)

    def ensure_occupancies(self) -> None:
        """Precompute all occupancy caches up-front (removes the reference's
        h5-write-during-training hazard, Datasets.py:242-252)."""
        for d in self.datalist:
            pc_h5 = os.path.join(os.path.dirname(d['h5_fn']),
                                 'farthest_pointclouds.h5')
            with h5.File(pc_h5, 'r') as f:
                pc = f['points_5000'][:]
            self._load_occ(d['h5_fn'], pc)

    def sample_queries(self, f, gen) -> np.ndarray:
        samples = []
        for i, num in enumerate(self.query_samples):
            s = self.sigmas[i]
            qdf = np.asarray(f['query_points_sigma_' + str(s)])
            idx = gen.integers(0, qdf.shape[0], int(num))
            samples.append(qdf[idx])
        return np.concatenate(samples, axis=0)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        data = self.datalist[index]
        cam_id = int(self._gen.integers(0, self.viewnum))
        rgb = self.read_rgb(data['rgba_dir'], cam_id)

        with _h5_lock, h5.File(data['h5_fn'], 'r') as f:
            samples = self.sample_queries(f, self._gen)
        points = samples[:, :3].astype(np.float32)
        values = samples[:, 3].astype(np.float32)

        pc_h5 = os.path.join(os.path.dirname(data['h5_fn']),
                             'farthest_pointclouds.h5')
        with _h5_lock, h5.File(pc_h5, 'r') as f:
            pc = f['points_5000'][:]

        occ = self._load_occ(data['h5_fn'], pc)
        return {'rgb_image': self.transforms(rgb, self._gen),
                'points': points, 'values': values,
                'occ': occ.astype(np.float32)}

    def get_testdata(self, cat_id: str, shape_id: str, cam_id) -> Dict:
        rgb_fn = os.path.join(self.config.image_dir, cat_id, shape_id, 'easy/')
        h5_fn = os.path.join(self.config.h5_dir, cat_id, shape_id,
                             'sampled_points.h5')
        mesh_fn = os.path.join(self.config.mesh_dir, cat_id, shape_id,
                               'isosurf_scaled.obj')
        rgb = self.read_rgb(rgb_fn, cam_id)
        gt_mesh = load_mesh(mesh_fn)
        return {'rgb_image': to_float(rgb)[None], 'gt_mesh': gt_mesh,
                'cat_id': cat_id, 'shape_id': shape_id}
