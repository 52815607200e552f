"""Host-side data: the ShapeNet readers of both stages, the synthetic
dataset and tree writer, the augmentations and the threaded loader."""

from list_tpu_torch.data.loader import DataLoader, collate  # noqa: F401
from list_tpu_torch.data.shapenet import (  # noqa: F401
    IM2PointFarthest, IM2SDF, read_shape_ids)
from list_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSDFDataset, SyntheticShape, box_sdf,
    generate_synthetic_shapenet, quantize_occupancy, sphere_sdf)
from list_tpu_torch.data.transforms import (  # noqa: F401
    ImageTransform, to_float)
