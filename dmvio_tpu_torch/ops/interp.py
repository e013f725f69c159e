"""Bilinear interpolation gathers on images and image stacks.

Counterpart of dmvio_tpu/ops/interp.py. The reference also carries
one-hot-matmul forms (`bilinear_mxu`, `bilinear_mxu_stack`) laid out for
the TPU's matrix unit; they compute the same bilinear sample, so the port
keeps only the gather forms below. Out-of-bounds coordinates are clamped;
callers mask OOB lanes separately.
"""

from __future__ import annotations

import torch

from dmvio_tpu_torch.ops._cast import to_int32


def _prep(x, y, h: int, w: int):
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return to_int32(x0).long(), to_int32(y0).long(), x - x0, y - y0


def bilinear(img: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H, W] at float coords (x/y-shaped result)."""
    h, w = img.shape[-2], img.shape[-1]
    ix, iy, dx, dy = _prep(x, y, h, w)
    flat = img.reshape(h * w)
    i00 = iy * w + ix
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    return (v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy)
            + v10 * (1 - dx) * dy + v11 * dx * dy)


def bilinear_stack(stack: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a [C, H, W] stack at shared coords -> [..., C]."""
    c, h, w = stack.shape
    ix, iy, dx, dy = _prep(x, y, h, w)
    flat = stack.reshape(c, h * w)
    i00 = (iy * w + ix).reshape(-1)
    dxf = dx.reshape(-1)[None]
    dyf = dy.reshape(-1)[None]
    out = (flat[:, i00] * (1 - dxf) * (1 - dyf)
           + flat[:, i00 + 1] * dxf * (1 - dyf)
           + flat[:, i00 + w] * (1 - dxf) * dyf
           + flat[:, i00 + w + 1] * dxf * dyf)            # [C, N]
    return out.transpose(0, 1).reshape(x.shape + (c,))


def nearest(img: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample of img [H, W] at float coords."""
    h, w = img.shape[-2], img.shape[-1]
    ix = to_int32(torch.clamp(torch.round(x), 0, w - 1)).long()
    iy = to_int32(torch.clamp(torch.round(y), 0, h - 1)).long()
    return img.reshape(h * w)[iy * w + ix]


def in_bounds(x: torch.Tensor, y: torch.Tensor, h: int, w: int,
              pad: float = 2.0) -> torch.Tensor:
    """Mask of samples at least `pad` pixels inside the image."""
    return (x > pad) & (x < w - pad - 1) & (y > pad) & (y < h - pad - 1)
