"""Split stage-1 CoarseNet submodule checkpoints for warm starting LIST
(counterpart of ``list_tpu/train/split_coarse.py``).

Reads a CoarseNet checkpoint of either format (the JAX package's msgpack
``.ckpt`` or the port's torch format) and writes its image encoder and
point decoder as ``best_IME_test`` / ``best_PD_test`` in the JAX package's
msgpack submodule format, which both packages' warm starts load.
CoarseNet names its encoder ``image_encoder``; LIST loads the same weights
into ``im_encoder`` and ``im_encoder2`` (train.py:187-210).

Usage:
  python -m list_tpu_torch.train.split_coarse --exp_name coarse_prediciton \
      [--checkpoint best_model_test.ckpt] [--output_dir ./results/]
"""

from __future__ import annotations

import argparse
import os

from list_tpu_torch.bridge import state_dict_to_flax
from list_tpu_torch.train.checkpoints import read_payload, write_submodule


def split_coarse_checkpoint(checkpoint_path: str, out_dir: str) -> None:
    payload, torch_format = read_payload(checkpoint_path)
    epoch = payload.get('epoch', 0)
    tree = (state_dict_to_flax(payload['state_dict']) if torch_format
            else payload['state_dict'])
    params = tree['params']
    stats = tree.get('batch_stats', {})

    def write(name_src: str, fname: str) -> None:
        path = os.path.join(out_dir, fname)
        write_submodule(epoch, params[name_src], stats.get(name_src, {}),
                        path)
        print('wrote', path)

    write('image_encoder', 'best_IME_test.ckpt')
    write('point_decoder', 'best_PD_test.ckpt')


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument('--exp_name', default='coarse_prediciton')
    p.add_argument('--output_dir', default='./results/')
    p.add_argument('--checkpoint', default='best_model_test.ckpt')
    args = p.parse_args(argv)
    ckpt_dir = os.path.join(args.output_dir, args.exp_name, 'checkpoints')
    split_coarse_checkpoint(os.path.join(ckpt_dir, args.checkpoint), ckpt_dir)


if __name__ == '__main__':
    main()
