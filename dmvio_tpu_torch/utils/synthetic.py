"""Analytic synthetic scenes and the synthetic VIO sequence.

Counterpart of dmvio_tpu/utils/synthetic.py (`default_scene`,
`room_scene`, `transform_scene`, `texture`, `render`, `ray_depth`,
`gt_idepth`, `generate_vio_sequence`): exact images from any viewpoint and
exact ground-truth inverse depths, with no files. Poses are world-to-cam
(R_cw, t_cw); a plane is { X : n . X = d } with an in-plane texture basis
(e1, e2) anchored at X0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

import dmvio_tpu_torch
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib


class PlaneScene(NamedTuple):
    n: torch.Tensor    # [3] unit plane normal (world)
    d: torch.Tensor    # scalar: n . X = d on the plane
    X0: torch.Tensor   # [3] texture anchor on the plane
    e1: torch.Tensor   # [3] in-plane texture axis
    e2: torch.Tensor   # [3]


def default_scene(depth: float = 2.0, device=None) -> PlaneScene:
    """Fronto-parallel-ish plane at z = depth (world = first cam frame), on
    `device`; None means CUDA (dmvio_tpu_torch.device)."""
    f32 = dict(dtype=torch.float32, device=dmvio_tpu_torch.device(device))
    n = torch.tensor([0.15, -0.1, 1.0], **f32)
    n = n / torch.linalg.norm(n)
    X0 = torch.tensor([0.0, 0.0, depth], **f32)
    d = n @ X0
    e1 = torch.tensor([1.0, 0.0, 0.0], **f32)
    e1 = e1 - (e1 @ n) * n
    e1 = e1 / torch.linalg.norm(e1)
    e2 = torch.linalg.cross(n, e1)
    return PlaneScene(n=n, d=d, X0=X0, e1=e1, e2=e2)


class MultiPlaneScene(NamedTuple):
    """Several textured planes; each ray sees the nearest one (a single
    infinite plane leaves the two-view init ambiguous). Fields are stacked
    per plane [P, ...]; `phase` decorrelates the per-plane textures."""

    n: torch.Tensor      # [P, 3] unit normals
    d: torch.Tensor      # [P]
    X0: torch.Tensor     # [P, 3]
    e1: torch.Tensor     # [P, 3]
    e2: torch.Tensor     # [P, 3]
    phase: torch.Tensor  # [P] texture phase offsets


def room_scene(depth: float = 2.0, device=None) -> MultiPlaneScene:
    """Back wall + floor + side wall around the origin (camera looks +z,
    +y is down), on `device`; None means CUDA."""
    f32 = dict(dtype=torch.float32, device=dmvio_tpu_torch.device(device))

    def unit(v):
        v = torch.tensor(v, **f32)
        return v / torch.linalg.norm(v)

    def frame(n):
        e1 = torch.tensor([1.0, 0.0, 0.0], **f32)
        e1 = e1 - (e1 @ n) * n
        nrm = torch.linalg.norm(e1)
        e1 = torch.where(nrm > 1e-3, e1 / torch.clamp(nrm, min=1e-9),
                         torch.tensor([0.0, 0.0, 1.0], **f32))
        return e1, torch.linalg.cross(n, e1)

    ns = torch.stack([unit([0.12, -0.08, 1.0]), unit([0.0, 1.0, 0.05]),
                      unit([1.0, 0.0, 0.08])])
    X0s = torch.tensor([[0.0, 0.0, depth + 0.8], [0.0, 0.9, 0.0],
                        [1.1, 0.0, 0.0]], **f32)
    e1s, e2s = zip(*(frame(ns[i]) for i in range(3)))
    return MultiPlaneScene(
        n=ns, d=torch.einsum("pi,pi->p", ns, X0s), X0=X0s,
        e1=torch.stack(e1s), e2=torch.stack(e2s),
        phase=torch.tensor([0.0, 2.1, 4.4], **f32))


def transform_scene(scene, R, t):
    """Rigidly transform a (Multi)PlaneScene in world coords: X' = R X + t
    (R, t numpy or tensors)."""
    dev = scene.n.device
    R = torch.as_tensor(np.asarray(R, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(t, np.float32), device=dev)
    if isinstance(scene, MultiPlaneScene):
        n = torch.einsum("ij,pj->pi", R, scene.n)
        X0 = torch.einsum("ij,pj->pi", R, scene.X0) + t
        return MultiPlaneScene(
            n=n, d=torch.einsum("pi,pi->p", n, X0), X0=X0,
            e1=torch.einsum("ij,pj->pi", R, scene.e1),
            e2=torch.einsum("ij,pj->pi", R, scene.e2), phase=scene.phase)
    n = R @ scene.n
    X0 = R @ scene.X0 + t
    return PlaneScene(n=n, d=n @ X0, X0=X0, e1=R @ scene.e1,
                      e2=R @ scene.e2)


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


def _multi_hits(scene: MultiPlaneScene, R_cw, t_cw, calib: Calib, u, v):
    """Nearest-plane ray depth [...], its plane index [...], world rays
    [..., 3] and the camera centre."""
    xr = (u - calib.cx) / calib.fx
    yr = (v - calib.cy) / calib.fy
    ray_c = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    R_wc, t_wc = lie.se3_inv(R_cw, t_cw)
    ray_w = torch.einsum("ij,...j->...i", R_wc, ray_c)
    denom = torch.einsum("...i,pi->...p", ray_w, scene.n)
    lam = (scene.d - scene.n @ t_wc) / torch.where(
        torch.abs(denom) > 1e-9, denom, torch.full_like(denom, 1e-9))
    # Only intersections in FRONT of the camera count; the nearest wins.
    lam_v = torch.where(lam > 0.05, lam, torch.full_like(lam, math.inf))
    lam_min, k = torch.min(lam_v, dim=-1)
    lam_min = torch.where(torch.isfinite(lam_min), lam_min,
                          torch.full_like(lam_min, 1e6))
    return lam_min, k, ray_w, t_wc


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


def ray_depth(scene, R_cw, t_cw, calib: Calib, u, v):
    """Depth along the pixel rays (u, v) [...]; idepth = 1 / depth."""
    if isinstance(scene, MultiPlaneScene):
        return _multi_hits(scene, R_cw, t_cw, calib, u, v)[0]
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
    if isinstance(scene, MultiPlaneScene):
        lam, k, ray_w, t_wc = _multi_hits(scene, R_cw, t_cw, calib, u, v)
        rel = ray_w * lam[..., None] + t_wc - scene.X0[k]
        a = torch.einsum("...i,...i->...", rel, scene.e1[k]) + scene.phase[k]
        b = torch.einsum("...i,...i->...", rel, scene.e2[k]) \
            + 0.7 * scene.phase[k]
        return math.exp(gain) * texture(a, b) + offset
    lam, ray_w, t_wc = _ray_hits(scene, R_cw, t_cw, calib, u, v)
    X = ray_w * lam[..., None] + t_wc
    rel = X - scene.X0
    a = torch.einsum("...i,i->...", rel, scene.e1)
    b = torch.einsum("...i,i->...", rel, scene.e2)
    return math.exp(gain) * texture(a, b) + offset


def gt_idepth(scene: PlaneScene, R_cw, t_cw, calib: Calib, u, v):
    """Exact inverse depth of the plane at pixels (u, v) of a frame."""
    return 1.0 / ray_depth(scene, R_cw, t_cw, calib, u, v)


def _so3_exp_f32(w: np.ndarray) -> np.ndarray:
    """The reference's float32 Rodrigues exponential (lie.so3_exp) on the
    host, so the generated trajectory follows its rounding."""
    w = np.asarray(w, np.float32)
    t2 = np.float32(np.sum(w * w, dtype=np.float32))
    t = np.sqrt(np.maximum(t2, np.float32(0.0)))
    if t2 < np.float32(1e-8):
        a = np.float32(1.0) - t2 / np.float32(6.0)
        b = np.float32(0.5) - t2 / np.float32(24.0)
    else:
        a = np.sin(t) / t
        b = (np.float32(1.0) - np.cos(t)) / t2
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]], np.float32)
    return np.eye(3, dtype=np.float32) + a * W + b * (W @ W)


def _body_to_dso_np(R_wb, p_wb, s, R_g, R_cb, t_cb):
    """Metric body pose -> DSO worldToCam (host float64; the exact inverse
    of the IMU factors' dso_to_body)."""
    R_bc = R_cb.T
    t_bc = -R_bc @ t_cb
    R_wc_m = R_wb @ R_bc
    t_wc_m = R_wb @ t_bc + p_wb
    R_wc_d = R_g @ R_wc_m
    t_wc_d = s * (R_g @ t_wc_m)
    return R_wc_d.T, -R_wc_d.T @ t_wc_d


def generate_vio_sequence(
    n_frames: int = 60,
    frame_dt: float = 0.05,
    imu_hz: float = 200.0,
    h: int = 256, w: int = 320,
    calib: Calib | None = None,
    scene=None,
    s_dso: float = 1.0,
    g2: tuple = (0.05, -0.03),
    accel_scale: float = 0.6,
    rot_scale: float = 0.5,
    imu_noise: bool = True,
    bias=(0.0,) * 6,
    seed: int = 0,
    excite: float = 0.0,
    excite_until: float = 0.0,
    v0=(0.22, -0.06, 0.1),
    R_cb=None,
    t_cb=None,
    device=None,
):
    """Full synthetic VIO sequence: rendered images + IMU + ground truth.

    The body trajectory integrates analytic world accelerations / body
    rates at IMU rate on the host, with the reference's numpy random draws
    in the reference's order; the DSO-world camera poses are the metric
    poses transformed by (scale s_dso, gravity tangent g2). Only the
    rendering runs in torch, on `device` (None means CUDA; a given scene
    or calib decides it). Returns the reference's dict: images [H, W]
    tensors, IMU samples, per-frame ground truth, timestamps, calib."""
    if scene is not None:
        dev = scene.n.device
    elif calib is not None:
        dev = calib.fx.device
    else:
        dev = dmvio_tpu_torch.device(device)
    if calib is None:
        calib = Calib.create(0.6 * w, 0.6 * w, w / 2 - 0.5, h / 2 - 0.5,
                             dev)
    if scene is None:
        scene = room_scene(depth=2.0, device=dev)
    rng = np.random.default_rng(seed)
    dt = 1.0 / imu_hz
    spf = max(int(round(frame_dt * imu_hz)), 1)
    n_steps = spf * (n_frames - 1)
    G = 9.8082
    g_vec = np.array([0.0, 0.0, -G])
    bias = np.asarray(bias, np.float64)

    def a_world(t):
        a = accel_scale * np.array([
            np.sin(2.3 * t), 0.8 * np.cos(1.9 * t) + 0.15,
            0.5 * np.sin(1.3 * t + 0.5)])
        if excite and (excite_until <= 0.0 or t < excite_until):
            # Scale-observability excitation, ramped down over the final
            # second before excite_until.
            amp = excite
            if excite_until > 0.0:
                amp = excite * min(1.0, max(0.0, excite_until - t))
            a = a + amp * np.array([
                np.sin(6.7 * t), np.cos(7.3 * t + 0.7),
                0.8 * np.sin(5.9 * t + 0.3)])
        return a

    def w_body(t):
        return rot_scale * np.array([
            0.5 * np.sin(1.6 * t) + 0.15, 0.45 * np.cos(1.2 * t),
            0.35 * np.sin(0.9 * t) - 0.1])

    R = np.eye(3)
    p = np.zeros(3)
    v = np.asarray(v0, np.float64).copy()
    accs, gyrs, imu_ts = [], [], []
    states = [(R.copy(), p.copy(), v.copy())]
    # Weak harmonic confinement keeps long sequences inside the scene.
    K_SPRING = 0.9
    C_DAMP = 0.5
    for k in range(n_steps):
        t = k * dt
        aw = a_world(t) - K_SPRING ** 2 * p - C_DAMP * v
        wb = w_body(t)
        na = rng.normal(0, 2.0e-3 / np.sqrt(dt), 3) if imu_noise else 0.0
        nw = rng.normal(0, 1.6968e-4 / np.sqrt(dt), 3) if imu_noise else 0.0
        accs.append(R.T @ (aw - g_vec) + bias[3:6] + na)
        gyrs.append(wb + bias[:3] + nw)
        imu_ts.append(t)
        p = p + v * dt + 0.5 * aw * dt ** 2
        v = v + aw * dt
        R = R @ _so3_exp_f32(wb * dt)
        states.append((R.copy(), p.copy(), v.copy()))

    R_g = _so3_exp_f32(np.array([g2[0], g2[1], 0.0])).astype(np.float64)
    if R_cb is not None:
        # Move the scene so the t=0 view is the identity rig's.
        R_cb64 = np.asarray(R_cb, np.float64)
        t_cb64 = np.asarray(t_cb, np.float64) if t_cb is not None \
            else np.zeros(3)
        R_f = R_g @ R_cb64.T @ R_g.T
        t_f = -s_dso * (R_g @ (R_cb64.T @ t_cb64))
        scene = transform_scene(scene, R_f, t_f)
        t_cb = t_cb64
    images, R_dso, t_dso, v_gt, p_gt, R_b = [], [], [], [], [], []
    for f in range(n_frames):
        Rb, pb, vb = states[f * spf]
        if R_cb is not None:
            R_cw_np, t_cw_np = _body_to_dso_np(
                np.asarray(Rb, np.float64), np.asarray(pb, np.float64),
                s_dso, R_g, np.asarray(R_cb, np.float64),
                np.asarray(t_cb, np.float64))
        else:
            R_wc_d = R_g @ Rb
            t_wc_d = s_dso * (R_g @ pb)
            R_cw_np, t_cw_np = R_wc_d.T, -R_wc_d.T @ t_wc_d
        R_cw = torch.as_tensor(np.asarray(R_cw_np, np.float32), device=dev)
        t_cw = torch.as_tensor(np.asarray(t_cw_np, np.float32), device=dev)
        images.append(render(scene, R_cw, t_cw, calib, h, w))
        R_dso.append(R_cw)
        t_dso.append(t_cw)
        v_gt.append(vb)
        p_gt.append(pb)
        R_b.append(Rb)
    return {
        "images": images,
        "timestamps": np.arange(n_frames) * frame_dt,
        "acc": np.asarray(accs, np.float32),
        "gyr": np.asarray(gyrs, np.float32),
        "imu_ts": np.asarray(imu_ts),
        "calib": calib,
        "scene": scene,
        "R_dso": R_dso, "t_dso": t_dso,
        "p_gt": np.asarray(p_gt), "v_gt": np.asarray(v_gt), "R_body": R_b,
        "steps_per_frame": spf, "imu_dt": dt,
        "s_dso": s_dso, "g2": np.asarray(g2),
    }
