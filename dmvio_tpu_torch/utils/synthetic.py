"""Analytic synthetic scene: a textured plane, renderable from any pose.

Counterpart of the visual part of dmvio_tpu/utils/synthetic.py
(`default_scene`, `texture`, `render`, `ray_depth`, `gt_idepth`): exact
images from any viewpoint and exact ground-truth inverse depths, with no
files. Poses are world-to-cam (R_cw, t_cw); the plane is { X : n . X = d }
with an in-plane texture basis (e1, e2) anchored at X0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib


class PlaneScene(NamedTuple):
    n: torch.Tensor    # [3] unit plane normal (world)
    d: torch.Tensor    # scalar: n . X = d on the plane
    X0: torch.Tensor   # [3] texture anchor on the plane
    e1: torch.Tensor   # [3] in-plane texture axis
    e2: torch.Tensor   # [3]


def default_scene(depth: float = 2.0, device="cpu") -> PlaneScene:
    """Fronto-parallel-ish plane at z = depth (world = first cam frame)."""
    f32 = dict(dtype=torch.float32, device=device)
    n = torch.tensor([0.15, -0.1, 1.0], **f32)
    n = n / torch.linalg.norm(n)
    X0 = torch.tensor([0.0, 0.0, depth], **f32)
    d = n @ X0
    e1 = torch.tensor([1.0, 0.0, 0.0], **f32)
    e1 = e1 - (e1 @ n) * n
    e1 = e1 / torch.linalg.norm(e1)
    e2 = torch.linalg.cross(n, e1)
    return PlaneScene(n=n, d=d, X0=X0, e1=e1, e2=e2)


def texture(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High-rank analytic texture in plane coordinates (meters), with a
    broadband high-frequency part (see dmvio_tpu for why)."""
    hf = (
        4.0 * torch.sin(47.0 * a + 0.7) * torch.cos(31.0 * b)
        + 3.5 * torch.cos(58.6 * b + 41.3 * a - 1.9)
        + 3.5 * torch.sin(52.7 * a - 36.1 * b + 2.6)
        + 3.0 * torch.cos(63.4 * a + 17.2 * b + 0.4)
        + 3.0 * torch.sin(23.9 * a + 55.8 * b + 1.6)
        + 2.5 * torch.cos(44.1 * a - 60.7 * b + 3.0)
        + 2.5 * torch.sin(39.2 * (a + 0.6 * b) + 0.9) * torch.cos(9.7 * b)
    )
    return (
        120.0
        + 40.0 * torch.sin(7.3 * a) * torch.cos(5.1 * b)
        + 25.0 * torch.sin(17.7 * a + 1.1)
        + 22.0 * torch.cos(13.3 * b + 2.3)
        + 15.0 * torch.sin(3.1 * (a + b))
        + 10.0 * torch.cos(29.0 * a - 23.0 * b)
        + hf
    )


def _ray_hits(scene: PlaneScene, R_cw, t_cw, calib: Calib, u, v):
    """Ray depth to the plane [...], world rays [..., 3], camera centre."""
    xr = (u - calib.cx) / calib.fx
    yr = (v - calib.cy) / calib.fy
    ray_c = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    R_wc, t_wc = lie.se3_inv(R_cw, t_cw)
    ray_w = torch.einsum("ij,...j->...i", R_wc, ray_c)
    denom = torch.einsum("...i,i->...", ray_w, scene.n)
    lam = (scene.d - scene.n @ t_wc) / torch.where(
        torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9))
    # Only intersections in FRONT of the camera count.
    lam = torch.where(lam > 0.05, lam, torch.full_like(lam, 1e6))
    return lam, ray_w, t_wc


def ray_depth(scene: PlaneScene, R_cw, t_cw, calib: Calib, u, v):
    """Depth along the pixel rays (u, v) [...]; idepth = 1 / depth."""
    return _ray_hits(scene, R_cw, t_cw, calib, u, v)[0]


def render(scene: PlaneScene, R_cw, t_cw, calib: Calib, h: int, w: int,
           gain: float = 0.0, offset: float = 0.0) -> torch.Tensor:
    """Render the [h, w] float32 image of the plane from a pose (exact).

    I = exp(gain) * irradiance + offset (the per-frame brightness model).
    Renders on the device of `scene`."""
    dev = scene.n.device
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                          torch.arange(w, device=dev, dtype=torch.float32),
                          indexing="ij")
    lam, ray_w, t_wc = _ray_hits(scene, R_cw, t_cw, calib, u, v)
    X = ray_w * lam[..., None] + t_wc
    rel = X - scene.X0
    a = torch.einsum("...i,i->...", rel, scene.e1)
    b = torch.einsum("...i,i->...", rel, scene.e2)
    return math.exp(gain) * texture(a, b) + offset


def gt_idepth(scene: PlaneScene, R_cw, t_cw, calib: Calib, u, v):
    """Exact inverse depth of the plane at pixels (u, v) of a frame."""
    return 1.0 / ray_depth(scene, R_cw, t_cw, calib, u, v)
