"""TUM-format trajectory IO and ATE evaluation.

Counterpart of dmvio_tpu/utils/trajectory.py: lines of
`timestamp tx ty tz qx qy qz qw` (cam-to-world) and the Sim(3)/SE(3)
Umeyama alignment used by the standard monocular evaluation tools.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from dmvio_tpu_torch.utils import lie


def write_tum(path: str, poses: Sequence[Tuple[float, np.ndarray, np.ndarray]]):
    """poses: iterable of (timestamp, R_wc [3,3], t_wc [3])."""
    with open(path, "w") as f:
        for ts, R, t in poses:
            q = lie.quat_from_rot(
                torch.tensor(np.asarray(R), dtype=torch.float32)).numpy()
            f.write(
                f"{ts:.9f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def read_tum(path: str) -> List[Tuple[float, np.ndarray, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            R = lie.rot_from_quat(torch.tensor([qx, qy, qz, qw],
                                               dtype=torch.float32)).numpy()
            out.append((ts, R, np.array([tx, ty, tz])))
    return out


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform s, R, t with y ~ s R x + t."""
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / x.shape[0]
    s = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def ate_rmse(est: Sequence[Tuple[float, np.ndarray, np.ndarray]],
             gt: Sequence[Tuple[float, np.ndarray, np.ndarray]],
             with_scale: bool = True,
             max_dt: float = 0.02) -> float:
    """ATE RMSE after Sim(3) (or SE(3)) alignment; poses associated by
    nearest timestamp within max_dt seconds."""
    gt_ts = np.array([g[0] for g in gt])
    pairs = []
    for ts, _, t in est:
        i = int(np.argmin(np.abs(gt_ts - ts)))
        if abs(gt_ts[i] - ts) <= max_dt:
            pairs.append((t, gt[i][2]))
    if len(pairs) < 3:
        return float("inf")
    x = np.stack([p[0] for p in pairs])
    y = np.stack([p[1] for p in pairs])
    s, R, t = umeyama_alignment(x, y, with_scale)
    err = (s * (R @ x.T).T + t) - y
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def path_length(positions: np.ndarray) -> float:
    """Total length of a polyline of camera centres [N, 3]."""
    p = np.asarray(positions, np.float64)
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())
