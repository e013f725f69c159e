"""Image pyramid with gradients ("makeImages").

Counterpart of dmvio_tpu/ops/pyramid.py: each level is one [3, H, W]
tensor (intensity, gx, gy); downsampling is 2x2 averaging, gradients are
central differences with zeroed borders.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from dmvio_tpu_torch.utils.camera import PYR_LEVELS


def _gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients; zero on the outermost rows/columns."""
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    gx[..., :, 0] = 0.0
    gx[..., :, -1] = 0.0
    gy[..., 0, :] = 0.0
    gy[..., -1, :] = 0.0
    return gx, gy


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling."""
    h, w = img.shape[-2], img.shape[-1]
    return img.reshape(img.shape[:-2] + (h // 2, 2, w // 2, 2)).mean(
        dim=(-3, -1))


def build_pyramid(img: torch.Tensor,
                  levels: int = PYR_LEVELS) -> List[torch.Tensor]:
    """[H, W] float32 image -> `levels` tensors [3, H>>l, W>>l]."""
    out = []
    cur = img
    for _ in range(levels):
        gx, gy = _gradients(cur)
        out.append(torch.stack([cur, gx, gy]))
        cur = _downsample2(cur)
    return out
