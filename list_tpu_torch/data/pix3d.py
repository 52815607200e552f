"""Pix3D real-image dataset (reference: datasets/Datasets.py:307-497),
copied from ``list_tpu/data/pix3d.py`` apart from imports: HDF5 files go
through ``utils/h5.py`` (the port does not need h5py), and
``quantize_occupancy`` is the one in ``data/synthetic.py``.

On-disk layout (identical to the reference's preprocessed Pix3D tree):
- <data_dir>/splits/{train,test}.json — lists of image files; entries
  containing 'flipped' are skipped.
- <data_dir>/data/pix3d.json — per-sample metadata (category, img, model).
- <data_dir>/data/img/<cat>/<model_folder>/<img>.npy — images as .npy.
- <data_dir>/data/sampled_points/<cat>/<model_folder>/sampled_points.h5
- <data_dir>/data/isosurface/<cat>/<model_folder>/{mesh_org.ply,
  isosurf_scaled.obj}

Images are resized to 224x224; batches additionally include the
coarse point cloud 'pc' subsampled from grid_points (Datasets.py:429-431).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, List

import numpy as np

from list_tpu_torch.data.synthetic import quantize_occupancy
from list_tpu_torch.data.transforms import ImageTransform, resize, to_float
from list_tpu_torch.utils import h5
from list_tpu_torch.utils.meshio import load_mesh

_h5_lock = threading.Lock()


class Pix3D:
    def __init__(self, config, mode: str):
        self.config = config
        self.mode = mode
        self.num_points = config.sample_point_density
        self.coarse_points = config.coarse_point_density
        self.vox_res = config.vox_res
        self.query_samples = np.rint(np.asarray(config.sample_distribution)
                                     * config.sample_point_density
                                     ).astype(np.uint32)
        self.sigmas = config.sigmas
        self.rng = np.random.RandomState(333)
        self._gen = np.random.default_rng(getattr(config, 'seed', 333))

        is_train = mode == 'train'
        # Reference hardcodes Resize(224) (Datasets.py:344); honoring
        # config.img_res (default 224) keeps parity while letting tiny CI
        # configs run the full Pix3D pipeline cheaply.
        self.img_res = getattr(config, 'img_res', 224)
        self.transforms = ImageTransform(
            random_h_flip=config.random_h_flip and is_train,
            color_jitter=config.color_jitter and is_train,
            normalize=config.normalize, resize_to=self.img_res)

        if mode == 'val':
            mode = 'test'
        split_file = os.path.join(config.data_dir, 'splits', mode + '.json')
        with open(split_file) as f:
            split = json.load(f)
        ids = [int(os.path.basename(fn).split('.')[0])
               for fn in split if 'flipped' not in fn]

        data_path = os.path.join(config.data_dir, 'data')
        with open(os.path.join(data_path, 'pix3d.json')) as f:
            metadatas = json.load(f)

        sample_info: List[Dict] = []
        skipped = 0
        for id_ in ids:
            metadata = metadatas[id_]
            if metadata['category'] not in config.catlist:
                continue
            info = {}
            _, cat, img = metadata['img'].split('/')
            model_folder = '.'.join(
                os.path.splitext(metadata['model'])[0].split('/')[-2:])
            img_name = os.path.splitext(img)[0]
            info['img_path'] = os.path.join(data_path, 'img', cat,
                                            model_folder, img_name + '.npy')
            info['query_path'] = os.path.join(data_path, 'sampled_points',
                                              cat, model_folder,
                                              'sampled_points.h5')
            info['mesh_path_orig'] = os.path.join(data_path, 'isosurface',
                                                  cat, model_folder,
                                                  'mesh_org.ply')
            info['mesh_path_norm'] = os.path.join(data_path, 'isosurface',
                                                  cat, model_folder,
                                                  'isosurf_scaled.obj')
            if not all(os.path.exists(p) for p in info.values()):
                skipped += 1
                continue
            info['sample_id'] = id_
            info['cat_id'] = metadata['category']
            info['shape_id'] = model_folder
            info['img_id'] = img
            sample_info.append(info)

        print(f'{skipped}/{len(ids)} missing samples')
        self.data_path = data_path
        self.datalist = sample_info
        print(f'Pix3D: loaded {len(self.datalist)} {mode} samples')

    def __len__(self):
        return len(self.datalist)

    def _occ_cache(self, query_path: str):
        occ_file = os.path.join(os.path.dirname(query_path),
                                'occupancies.h5')
        key = f'res_{self.vox_res}_points_{self.coarse_points}'
        return occ_file, key

    def ensure_occupancies(self) -> None:
        """Precompute all occupancy caches up-front (removes the reference's
        h5-write-during-training hazard, Datasets.py:242-252 — workers
        append to a shared 'a'-mode file mid-epoch).  The cache key ignores
        which random coarse subsample produced the grid (reference caches
        whichever ran first); here the precompute uses a deterministic
        subsample so the artifact is reproducible."""
        seed = getattr(self.config, 'seed', 333)
        for data in self.datalist:
            occ_file, key = self._occ_cache(data['query_path'])
            with _h5_lock, h5.File(occ_file, 'a') as f:
                if key in f.keys():
                    continue
                with h5.File(data['query_path'], 'r') as q:
                    pc = q['grid_points'][:]
                # Per-item rng (seed + path hash): each cache entry is the
                # same regardless of which entries were already warm.
                gen = np.random.default_rng(
                    (seed, zlib.crc32(data['query_path'].encode())))
                pc = pc[gen.integers(0, pc.shape[0], self.coarse_points)]
                occ = quantize_occupancy(pc, self.config.bb_min,
                                         self.config.bb_max, self.vox_res)
                f.create_dataset(key, data=occ, compression='gzip')

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        data = self.datalist[index]
        img = np.load(data['img_path'])

        with _h5_lock, h5.File(data['query_path'], 'r') as f:
            samples = []
            for i, num in enumerate(self.query_samples):
                s = self.sigmas[i]
                qdf = np.asarray(f['query_points_sigma_' + str(s)])
                idx = self._gen.integers(0, qdf.shape[0], int(num))
                samples.append(qdf[idx])
            samples = np.concatenate(samples, 0)
            pc = f['grid_points'][:]
        choice = self._gen.integers(0, pc.shape[0], self.coarse_points)
        pc = pc[choice]

        occ_file, key = self._occ_cache(data['query_path'])
        with _h5_lock:
            occ = None
            if os.path.exists(occ_file):
                # pure read-only when the cache exists (no 'a'-mode handle
                # mid-epoch; ensure_occupancies() prefills these)
                with h5.File(occ_file, 'r') as f:
                    if key in f.keys():
                        occ = f[key][:]
            if occ is None:
                occ = quantize_occupancy(pc, self.config.bb_min,
                                         self.config.bb_max, self.vox_res)
                with h5.File(occ_file, 'a') as f:
                    f.create_dataset(key, data=occ, compression='gzip')
        occ = occ.reshape((self.vox_res,) * 3)

        return {'rgb_image': self.transforms(img, self._gen),
                'points': samples[:, :3].astype(np.float32),
                'values': samples[:, 3].astype(np.float32),
                'occ': occ.astype(np.float32),
                'pc': pc.astype(np.float32)}

    def get_testdata(self, cat: str, model_folder: str, img_name) -> Dict:
        data_path = self.data_path
        rgb_fn = os.path.join(data_path, 'img', cat, model_folder,
                              str(img_name) + '.npy')
        h5_fn = os.path.join(data_path, 'sampled_points', cat, model_folder,
                             'sampled_points.h5')
        mesh_fn = os.path.join(data_path, 'isosurface', cat, model_folder,
                               'isosurf_scaled.obj')
        rgb = np.load(rgb_fn)
        gt_mesh = load_mesh(mesh_fn)
        with h5.File(h5_fn, 'r') as f:
            pc = f['grid_points'][:]
        choice = self.rng.randint(0, pc.shape[0], self.coarse_points)
        pc = pc[choice]
        img = resize(to_float(rgb), self.img_res)
        return {'rgb_image': img[None], 'gt_mesh': gt_mesh,
                'pc': pc.astype(np.float32), 'cat_id': cat,
                'shape_id': model_folder}
