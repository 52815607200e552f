"""Executors and optimizer of the port."""

from list_tpu_torch.train.executors import LISTExecutor, total_loss  # noqa: F401
from list_tpu_torch.train.state import make_optimizer  # noqa: F401
