"""Candidate pixel selection on gradient maps.

Counterpart of dmvio_tpu/ops/select.py (PixelSelector2 as array ops):
per-block robust gradient thresholds, one winner per `pot` cell, a second
pass at 2*pot for empty cells, then a fixed-capacity top-K. The top-K is a
stable descending sort, which breaks ties by the lower flat index exactly
like `jax.lax.top_k` (torch.topk leaves the tie order unspecified).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from dmvio_tpu_torch.ops._cast import to_int32

MIN_GRAD_HIST_ADD = 7.0
BLOCK = 32


class Selection(NamedTuple):
    u: torch.Tensor      # [K] float32 pixel x
    v: torch.Tensor      # [K] float32 pixel y
    score: torch.Tensor  # [K] gradient magnitude^2 at the pixel
    mask: torch.Tensor   # [K] bool valid


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median as numpy/jnp compute it: the mean of the two middle values
    for an even count (torch.median returns the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return (lo * 0.5 + hi * 0.5).squeeze(dim)


def _block_thresholds(gsq: torch.Tensor, block: int) -> torch.Tensor:
    """(median(|grad|) + MIN_GRAD_HIST_ADD)^2 per block, per pixel."""
    h, w = gsq.shape
    gb = torch.sqrt(gsq.reshape(h // block, block, w // block, block))
    med = median(gb.permute(0, 2, 1, 3).reshape(
        h // block, w // block, block * block), dim=-1)
    th = (med + MIN_GRAD_HIST_ADD) ** 2
    return th.repeat_interleave(block, 0).repeat_interleave(block, 1)


def _cell_nms(score: torch.Tensor, pot: int) -> torch.Tensor:
    """Keep only the max-scoring pixel per pot x pot cell (first on ties)."""
    h, w = score.shape
    cells = score.reshape(h // pot, pot, w // pot, pot).permute(0, 2, 1, 3)
    cells = cells.reshape(h // pot, w // pot, pot * pot)
    best = torch.argmax(cells, dim=-1)
    keep = F.one_hot(best, pot * pot).to(score.dtype)
    out = (cells * keep).reshape(h // pot, w // pot, pot, pot)
    return out.permute(0, 2, 1, 3).reshape(h, w)


def select_points(level0: torch.Tensor, k: int, pot: int = 4,
                  border: int = 4) -> Selection:
    """Select up to k well-spread high-gradient pixels (static shapes)."""
    _, h, w = level0.shape
    dev = level0.device
    gsq = level0[1] ** 2 + level0[2] ** 2
    th = _block_thresholds(gsq, BLOCK)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inb = (xx >= border) & (xx < w - border) & (yy >= border) & \
        (yy < h - border)
    zero = torch.zeros_like(gsq)
    s1 = _cell_nms(torch.where((gsq > th) & inb, gsq, zero), pot)
    s2 = _cell_nms(torch.where((gsq > 0.25 * th) & inb, gsq, zero), pot * 2)
    p2 = pot * 2
    occ1 = s1.reshape(h // p2, p2, w // p2, p2).amax(dim=(1, 3)) > 0
    occ1 = occ1.repeat_interleave(p2, 0).repeat_interleave(p2, 1)
    score = torch.where(s1 > 0, s1 + 1e6, torch.where(occ1, zero, s2))

    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    u = (idx % w).to(torch.float32)
    v = (idx // w).to(torch.float32)
    return Selection(u=u, v=v, score=torch.where(top > 1e5, top - 1e6, top),
                     mask=top > 0.0)


def occupancy_spacing(u_exist, v_exist, exist_mask, u_cand, v_cand,
                      h: int, w: int, radius: int = 2,
                      cell: int = 8) -> torch.Tensor:
    """Candidate is clear if no existing point lies within `radius` cells
    of its `cell`-sized grid cell (occupancy grid + 3x3 max dilations)."""
    gh, gw = h // cell, w // cell
    gx = torch.clamp(to_int32(u_exist / cell), 0, gw - 1).long()
    gy = torch.clamp(to_int32(v_exist / cell), 0, gh - 1).long()
    occ = torch.zeros(gh * gw, dtype=torch.float32, device=u_exist.device)
    # Integer-valued counts: exact in any summation order.
    occ.index_put_((gy * gw + gx,), exist_mask.to(torch.float32),
                   accumulate=True)
    occ = (occ > 0).to(torch.float32).reshape(1, 1, gh, gw)
    for _ in range(min(max(int(radius), 0), 2)):
        occ = F.max_pool2d(occ, 3, stride=1, padding=1)
    cx = torch.clamp(to_int32(u_cand / cell), 0, gw - 1).long()
    cy = torch.clamp(to_int32(v_cand / cell), 0, gh - 1).long()
    return occ[0, 0][cy, cx] <= 0
