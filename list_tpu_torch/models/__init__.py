"""Model modules of the port (names follow ``list_tpu.models``)."""

from list_tpu_torch.models.list_model import (  # noqa: F401
    LIST, CoarseNet, SpatialTransformer)
from list_tpu_torch.models.percep import PerceptualPooling  # noqa: F401
from list_tpu_torch.models.pointmlp import PointMLP  # noqa: F401
from list_tpu_torch.models.resnet import ResEncoder  # noqa: F401
from list_tpu_torch.models.treegcn import TreeGCN, TreeGraphDecoder  # noqa: F401
from list_tpu_torch.models.voxel import VoxelDecoder2, VoxelEncoder2  # noqa: F401
