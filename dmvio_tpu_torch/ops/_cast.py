"""XLA's saturating float32 -> int32 conversion, reproduced in PyTorch.

XLA converts NaN to 0 and clamps out-of-range values to INT32_MIN/MAX:
`jnp.floor(x).astype(int32)` maps [1e10, -1e10, nan, inf, -inf] to
[INT_MAX, INT_MIN, 0, INT_MAX, INT_MIN]. A plain `.to(torch.int32)` is
undefined there (on the CPU it gives INT_MIN for all five). Every place
where the reference casts a possibly non-finite float to int32 (the
bilinear corner index, the patch anchors, the grid-cell index of the
occupancy maps) goes through `to_int32` so the port yields the same index.
"""

from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1
INT32_MIN = -(2 ** 31)
# Largest float32 strictly below 2**31.
_F32_BELOW_2_31 = 2147483520.0


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncating float -> int32 cast with XLA's saturation semantics."""
    big = x >= 2.0 ** 31
    xi = torch.nan_to_num(x, nan=0.0, posinf=_F32_BELOW_2_31,
                          neginf=float(INT32_MIN))
    xi = torch.clamp(xi, float(INT32_MIN), _F32_BELOW_2_31).to(torch.int32)
    return torch.where(big, torch.full_like(xi, INT32_MAX), xi)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into the int32 range (the
    reference's int32 arithmetic overflows this way)."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31
