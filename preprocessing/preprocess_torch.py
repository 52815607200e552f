#!/usr/bin/env python3
"""Offline SDF-sampling CLI of the PyTorch port (see
list_tpu_torch/data/preprocess.py):

    python preprocessing/preprocess_torch.py --input_dir <raw tree>/ \
        --output_dir <dataset root>/ --categories <cat> \
        --file_path_glob '/*/model.obj' [--num_points 50000] \
        [--sigma 0.003 0.01 0.07] [--workers N]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from list_tpu_torch.data.preprocess import main  # noqa: E402

if __name__ == '__main__':
    main()
