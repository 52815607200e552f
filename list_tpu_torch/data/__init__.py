"""Host-side data: the synthetic dataset (train and test sweep) and the
ShapeNet stage-2 dataset's test side."""

from list_tpu_torch.data.loader import collate  # noqa: F401
from list_tpu_torch.data.shapenet import IM2SDF, read_shape_ids  # noqa: F401
from list_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSDFDataset, SyntheticShape, box_sdf, quantize_occupancy,
    sphere_sdf)
from list_tpu_torch.data.transforms import to_float  # noqa: F401
