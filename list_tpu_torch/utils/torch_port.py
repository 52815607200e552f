"""Import torchvision ResNet18 weights into the port's ``ResEncoder``
(counterpart of ``list_tpu/utils/torch_port.py``; ``--resnet_ckpt``).

The reference builds its encoders from ImageNet-pretrained torchvision
ResNet18 (network/modules.py:1030).  A torchvision ``resnet18`` state dict
file (``.pt``/``.pth`` read with ``torch.load``, or ``.npz`` of the same
keys) maps onto every image encoder of the model by key, without
torchvision:

- ``bn1``, ``layer{1-4}.{0,1}.{conv1,bn1,conv2,bn2}``, the blocks'
  ``downsample.0`` / ``downsample.1`` -> ``downsample_conv`` /
  ``downsample_bn``, and ``fc``, in torch's own layouts;
- ``conv1`` is not taken: the encoder's stride-1 7x7 ``conv1`` replaces
  torchvision's (the reference does the same, modules.py:1032-1033), and
  ``fc1`` (1000 -> 128) is LIST's own head; both keep their init.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

ENCODER_NAMES = ('im_encoder', 'im_encoder2', 'image_encoder')
_BN = ('weight', 'bias', 'running_mean', 'running_var')


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision state dict from ``.npz`` or a ``torch.load`` file
    (the dict itself, or under a ``'state_dict'`` key)."""
    if path.endswith('.npz'):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd.get('state_dict'), dict):
        sd = sd['state_dict']
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def resencoder_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision keys -> the ``ResEncoder``'s (KeyError if one is
    missing)."""
    out = {f'bn1.{leaf}': sd[f'bn1.{leaf}'] for leaf in _BN}
    for li in range(1, 5):
        for bi in range(2):
            src, dst = f'layer{li}.{bi}', f'layer{li}_{bi}'
            for conv in ('conv1', 'conv2'):
                out[f'{dst}.{conv}.weight'] = sd[f'{src}.{conv}.weight']
            for bn in ('bn1', 'bn2'):
                for leaf in _BN:
                    out[f'{dst}.{bn}.{leaf}'] = sd[f'{src}.{bn}.{leaf}']
            if f'{src}.downsample.0.weight' in sd:
                out[f'{dst}.downsample_conv.weight'] = \
                    sd[f'{src}.downsample.0.weight']
                for leaf in _BN:
                    out[f'{dst}.downsample_bn.{leaf}'] = \
                        sd[f'{src}.downsample.1.{leaf}']
    out['fc.weight'], out['fc.bias'] = sd['fc.weight'], sd['fc.bias']
    return out


def apply_resnet_ckpt(model: torch.nn.Module, path: str) -> List[str]:
    """Load the file's weights into every image encoder ``model`` has (in
    place, shapes checked) -> the names of the encoders loaded."""
    mapped = resencoder_keys(load_state_dict_file(path))
    hit = []
    for name in ENCODER_NAMES:
        enc = getattr(model, name, None)
        if enc is None:
            continue
        state = enc.state_dict()
        state.update({k: v.to(state[k].dtype) for k, v in mapped.items()})
        enc.load_state_dict(state, strict=True)
        hit.append(name)
    if not hit:
        raise ValueError(f'no image encoder found among {ENCODER_NAMES}')
    return hit
