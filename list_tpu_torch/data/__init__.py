"""Host-side data for the port's train path: the synthetic dataset."""

from list_tpu_torch.data.loader import collate  # noqa: F401
from list_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSDFDataset, SyntheticShape, box_sdf, quantize_occupancy,
    sphere_sdf)
