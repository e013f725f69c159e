"""Camera calibration and global geometry constants.

Counterpart of dmvio_tpu/utils/camera.py: per-level pinhole intrinsics
(the reference's globalCalib.h) and the 8-pixel residual pattern
(settings.h staticPattern[8]). `Calib` holds 0-d float32 tensors on the
working device, so intrinsics updated by bundle adjustment never leave it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Number of pyramid levels (reference settings.h:52 PYR_LEVELS=6).
PYR_LEVELS = 6

# 8-point residual pattern (dx, dy) offsets around the central pixel.
PATTERN = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.float32,
)
PATTERN_NUM = 8
# Padding needed so the whole pattern stays in-bounds.
PATTERN_PAD = 2
# Index of the (0, 0) offset in PATTERN.
PATTERN_CENTER = 4


def pattern(device) -> torch.Tensor:
    """PATTERN as a [8, 2] float32 tensor on `device`."""
    return torch.as_tensor(PATTERN, device=device)


@dataclasses.dataclass(frozen=True)
class Calib:
    """Pinhole intrinsics at pyramid level 0. fx, fy, cx, cy are 0-d f32."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, device="cpu") -> "Calib":
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return Calib(f32(fx), f32(fy), f32(cx), f32(cy))

    @property
    def device(self) -> torch.device:
        return self.fx.device

    def to(self, device) -> "Calib":
        return Calib(*(getattr(self, f).to(device) for f in
                       ("fx", "fy", "cx", "cy")))

    def at_level(self, level: int) -> "Calib":
        """Intrinsics at pyramid level `level` (half-pixel-centre convention:
        pixel (x, y) on level l is (2x + 0.5, 2y + 0.5) on level l-1)."""
        s = 0.5 ** level
        return Calib(self.fx * s, self.fy * s,
                     (self.cx + 0.5) * s - 0.5, (self.cy + 0.5) * s - 0.5)

    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, z, self.cx]),
                            torch.stack([z, self.fy, self.cy]),
                            torch.stack([z, z, o])])

    def as_vec(self) -> torch.Tensor:
        return torch.stack([self.fx, self.fy, self.cx, self.cy])

    @staticmethod
    def from_vec(v: torch.Tensor) -> "Calib":
        return Calib(v[0], v[1], v[2], v[3])


def level_shapes(h: int, w: int,
                 levels: int = PYR_LEVELS) -> Tuple[Tuple[int, int], ...]:
    """Image (h, w) per pyramid level."""
    return tuple((h >> l, w >> l) for l in range(levels))


def project(calib: Calib, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (u, v)."""
    z = p_cam[..., 2]
    u = p_cam[..., 0] / z * calib.fx + calib.cx
    v = p_cam[..., 1] / z * calib.fy + calib.cy
    return torch.stack([u, v], dim=-1)


def backproject(calib: Calib, uv: torch.Tensor,
                idepth: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] with inverse depth [...] -> camera points [..., 3]."""
    x = (uv[..., 0] - calib.cx) / calib.fx
    y = (uv[..., 1] - calib.cy) / calib.fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return ray / idepth[..., None]
