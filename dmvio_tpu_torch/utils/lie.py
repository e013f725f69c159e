"""Batched Lie-group operations (SO3 / SE3 / Sim3) in PyTorch.

Counterpart of dmvio_tpu/utils/lie.py, same conventions: rotations are
3x3 matrices, the SE3 tangent is [v (3), w (3)], retraction is LEFT-
multiplicative (retract(T, d) = exp(d) @ T), and every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., i, j] x [..., j] -> [..., i]."""
    return (M * v.unsqueeze(-2)).sum(-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta_sq(w: torch.Tensor) -> torch.Tensor:
    return torch.sum(w * w, dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential, small-angle safe: [..., 3] -> [..., 3, 3]."""
    t2 = _theta_sq(w)
    t = torch.sqrt(torch.clamp(t2, min=0.0))
    small = t2 < _EPS
    one = torch.ones_like(t)
    a = torch.where(small, 1.0 - t2 / 6.0,
                    torch.sin(t) / torch.where(small, one, t))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.where(small, one, t2))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm SO3 -> so3, [..., 3, 3] -> [..., 3], including the
    well-conditioned axis recovery near t = pi (see dmvio_tpu)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    anti = vee(R - R.transpose(-1, -2))          # 2 sin(t) * axis
    sin2 = 0.25 * torch.sum(anti * anti, dim=-1)
    small = sin2 < 1e-12
    sin_safe = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    t = torch.atan2(sin_safe, cos_t)
    factor = torch.where(small, 0.5 + (1.0 - cos_t) / 6.0,
                         0.5 * t / sin_safe)
    w = anti * factor[..., None]
    near_pi = cos_t < -0.97
    S = (R + R.transpose(-1, -2)) * 0.5
    denom = torch.clamp(1.0 - cos_t, min=_EPS)
    aaT = (S - cos_t[..., None, None] * _eye_like(S)) / denom[..., None, None]
    diag = torch.stack([aaT[..., 0, 0], aaT[..., 1, 1], aaT[..., 2, 2]], -1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(aaT, -1, k[..., None, None].expand(
        aaT.shape[:-1] + (1,)))[..., 0]
    pivot = torch.sqrt(torch.clamp(
        torch.gather(diag, -1, k[..., None])[..., 0], min=_EPS))
    axis = col / pivot[..., None]
    s = torch.sign(torch.sum(anti * axis, dim=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    u = torch.sqrt(torch.clamp(2.0 * (1.0 + cos_t), min=0.0))
    t_pi = math.pi - u * (1.0 + u * u / 24.0)
    w_pi = axis * (s * t_pi)[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    t2 = _theta_sq(w)
    t = torch.sqrt(torch.clamp(t2, min=0.0))
    small = t2 < _EPS
    one = torch.ones_like(t)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.where(small, one, t2))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / torch.where(small, one, t2 * t))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    t2 = _theta_sq(w)
    t = torch.sqrt(torch.clamp(t2, min=0.0))
    small = t2 < _EPS
    one = torch.ones_like(t)
    half_t = 0.5 * t
    cot = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half_t * torch.cos(half_t)
         / torch.where(small, one, torch.sin(half_t)))
        / torch.where(small, one, t2))
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor):
    """se3 -> SE3: xi = [v, w] ([..., 6]) -> (R, t)."""
    v, w = xi[..., :3], xi[..., 3:6]
    return so3_exp(w), _mv(_so3_left_jacobian(w), v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE3 -> se3, returns [..., 6] = [v, w]."""
    w = so3_log(R)
    v = _mv(_so3_left_jacobian_inv(w), t)
    return torch.cat([v, w], dim=-1)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb)."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_retract(R, t, xi):
    """Left-multiplicative retraction: exp(xi) @ (R, t)."""
    dR, dt = se3_exp(xi)
    return se3_mul(dR, dt, R, t)


def se3_adj(R, t) -> torch.Tensor:
    """Adjoint under [v, w] ordering: [[R, hat(t) R], [0, R]] ([..., 6, 6])."""
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def quat_from_rot(R: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Rotation matrix -> quaternion [qx, qy, qz, qw] (Shepperd's method);
    normalize=False returns the candidate before its division by its
    norm."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = sq(tr + 1.0)
    cw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                      0.25 * s], -1)
    s = sq(1.0 + m00 - m11 - m22)
    cx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                      (m21 - m12) / s], -1)
    s = sq(1.0 + m11 - m00 - m22)
    cy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                      (m02 - m20) / s], -1)
    s = sq(1.0 + m22 - m00 - m11)
    cz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                      (m10 - m01) / s], -1)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    if not normalize:
        return q
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [qx, qy, qz, qw] -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.clamp(n, min=_EPS)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# Host float64 helpers (numpy), used by the tracker's rescue candidates.
# ---------------------------------------------------------------------------


def _hat_np(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def exp_so3_np(w):
    """Rodrigues exponential on host float64 (3-vector -> 3x3)."""
    t = np.linalg.norm(w)
    W = _hat_np(w)
    if t < 1e-8:
        return np.eye(3) + W + 0.5 * W @ W
    return (np.eye(3) + np.sin(t) / t * W
            + (1 - np.cos(t)) / (t * t) * W @ W)


def log_so3_np(R):
    """Logarithm on host float64 (3x3 -> 3-vector), away from t = pi."""
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    anti = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_t = 0.5 * np.linalg.norm(anti)
    t = np.arctan2(sin_t, cos_t)
    if sin_t < 1e-8:
        return 0.5 * anti
    return anti * (0.5 * t / sin_t)
