"""Host-side data: the ShapeNet readers of both stages, the Pix3D reader,
the synthetic dataset and tree writer, the augmentations, the threaded
loader and the offline preprocessing (``data/preprocess.py``)."""

from list_tpu_torch.data.loader import DataLoader, collate  # noqa: F401
from list_tpu_torch.data.pix3d import Pix3D  # noqa: F401
from list_tpu_torch.data.shapenet import (  # noqa: F401
    IM2PointFarthest, IM2SDF, read_shape_ids)
from list_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticSDFDataset, SyntheticShape, box_sdf, generate_synthetic_pix3d,
    generate_synthetic_shapenet, quantize_occupancy, sphere_sdf)
from list_tpu_torch.data.transforms import (  # noqa: F401
    ImageTransform, to_float)
