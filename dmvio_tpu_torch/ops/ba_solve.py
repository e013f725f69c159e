"""Sliding-window BA linear algebra: H/b assembly, Schur, marginalization.

Counterpart of dmvio_tpu/ops/ba_solve.py (AccumulatedTopHessian,
AccumulatedSCHessian, EnergyFunctional::marginalizeFrame /
marginalizePointsF / orthogonalize as dense masked tensor algebra).
State ordering: x = [calib(4) | 8 per frame x F], C = 4 + 8 F. The
marginalization prior (HM, bM0) is in the "zero" convention: the effective
gradient is bM0 + HM @ delta with delta = state (-) FEJ.

The normal equations are assembled blockwise: each (target f, point p)
pair touches only the calib block, its target block and its host block;
host blocks are placed by one-hot [P, F] contractions. All products are
full float32 (TF32 is off, see dmvio_tpu_torch/__init__.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dmvio_tpu_torch.ops.residuals import BAFrames, BAResiduals
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib

CPART = 4  # calib block size


def cdim(F: int) -> int:
    return CPART + 8 * F


class BASystem(NamedTuple):
    """Assembled normal equations of the active photometric residuals."""

    H: torch.Tensor       # [C, C]
    b: torch.Tensor       # [C]
    H_fd: torch.Tensor    # [P, C]
    H_dd: torch.Tensor    # [P]
    b_d: torch.Tensor     # [P]
    energy: torch.Tensor  # scalar robust photometric energy
    num_terms: torch.Tensor


def state_delta(frames: BAFrames, calib: Calib,
                calib0: torch.Tensor) -> torch.Tensor:
    """delta = current state (-) FEJ state in the [C] layout (pose part is
    the left increment log(T_cur T_fej^-1))."""
    R0inv, t0inv = lie.se3_inv(frames.R0_cw, frames.t0_cw)
    Rd, td = lie.se3_mul(frames.R_cw, frames.t_cw, R0inv, t0inv)
    fdelta = torch.cat([lie.se3_log(Rd, td), frames.aff - frames.aff0], -1)
    fdelta = torch.where(frames.mask[:, None], fdelta,
                         torch.zeros_like(fdelta))
    return torch.cat([calib.as_vec() - calib0, fdelta.reshape(-1)])


def accumulate(res: BAResiduals, host: torch.Tensor, F: int) -> BASystem:
    """Blockwise normal equations (no full-Jacobian scatter)."""
    P = host.shape[0]
    Jt = torch.cat([res.J_pose_t, res.J_aff_t], dim=-1)      # [F,P,K,8]
    Jh = torch.cat([res.J_pose_h, res.J_aff_h], dim=-1)
    Jc = res.J_calib                                          # [F,P,K,4]
    w = res.wt
    r = res.r
    O = torch.nn.functional.one_hot(host.long(), F).to(Jt.dtype)  # [P, F]
    es = torch.einsum

    wJt = Jt * w[..., None]
    wJh = Jh * w[..., None]
    wJc = Jc * w[..., None]

    h_tt = es("fpka,fpkb->fab", wJt, Jt)
    h_hh = es("fpka,fpkb->pab", wJh, Jh)
    h_hh_g = es("pg,pab->gab", O, h_hh)
    h_th = es("fpka,fpkb->fpab", wJt, Jh)
    h_th_g = es("pg,fpab->fgab", O, h_th)                     # [F,F,8,8]
    eyeF = torch.eye(F, dtype=Jt.dtype, device=Jt.device)
    M = (es("fab,fg->fagb", h_tt + h_hh_g, eyeF)
         + h_th_g.permute(0, 2, 1, 3)
         + h_th_g.permute(1, 3, 0, 2))
    H_ff = M.reshape(8 * F, 8 * F)

    H_cc = es("fpka,fpkb->ab", wJc, Jc)
    h_tc = es("fpka,fpkb->fab", wJt, Jc)
    h_hc = es("pg,pab->gab", O, es("fpka,fpkb->pab", wJh, Jc))
    H_fc = (h_tc + h_hc).reshape(8 * F, CPART)
    H = torch.cat([torch.cat([H_cc, H_fc.T], dim=1),
                   torch.cat([H_fc, H_ff], dim=1)], dim=0)

    b_c = es("fpka,fpk->a", wJc, r)
    b_t = es("fpka,fpk->fa", wJt, r)
    b_h = es("pg,pa->ga", O, es("fpka,fpk->pa", wJh, r))
    b = torch.cat([b_c, (b_t + b_h).reshape(-1)])

    wJdd = w * res.J_dd
    fd_c = es("fpk,fpkb->pb", wJdd, Jc)
    fd_t = es("fpk,fpka->pfa", wJdd, Jt)
    fd_h = es("pg,pa->pga", O, es("fpk,fpka->pa", wJdd, Jh))
    H_fd = torch.cat([fd_c, (fd_t + fd_h).reshape(P, 8 * F)], dim=1)
    H_dd = es("fpk,fpk->p", wJdd, res.J_dd)
    b_d = es("fpk,fpk->p", wJdd, r)
    return BASystem(H=H, b=b, H_fd=H_fd, H_dd=H_dd, b_d=b_d,
                    energy=torch.sum(res.energy),
                    num_terms=torch.sum(res.active.to(torch.float32)))


def nullspaces(frames: BAFrames, F: int) -> torch.Tensor:
    """Gauge nullspace directions N [C, 7] at the FEJ poses (3 global
    translations, 3 rotations, 1 scale)."""
    n_se3 = -lie.se3_adj(frames.R0_cw, frames.t0_cw)           # [F, 6, 6]
    n_scale = torch.cat([frames.t0_cw, torch.zeros_like(frames.t0_cw)],
                        dim=-1)[..., None]                     # [F, 6, 1]
    n_pose = torch.cat([n_se3, n_scale], dim=-1)
    n_pose = torch.where(frames.mask[:, None, None], n_pose,
                         torch.zeros_like(n_pose))
    N = torch.zeros(cdim(F), 7, dtype=n_pose.dtype, device=n_pose.device)
    for j in range(F):
        N[CPART + 8 * j: CPART + 8 * j + 6] = n_pose[j]
    return N


def orthogonalize_step(dx: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """Remove gauge components from a step: dx - N pinv(N) dx."""
    G = N.T @ N + 1e-9 * torch.eye(N.shape[1], dtype=N.dtype,
                                   device=N.device)
    coef = torch.linalg.solve_ex(G, N.T @ dx)[0]
    return dx - N @ coef


def solve_levenberg(sys: BASystem, HM, bM_eff, H_prior_diag, b_prior, lam,
                    frame_mask, point_mask, N_null=None):
    """One damped GN solve with point Schur (solveSystemF). Returns
    (dx_f [C], dx_d [P]); unoccupied slots and inactive points get exact
    zero steps."""
    dev = sys.H.device
    Hdd = sys.H_dd * (1.0 + lam) + 1e-10
    Hdd_inv = torch.where(point_mask, 1.0 / Hdd, torch.zeros_like(Hdd))
    Hfd_w = sys.H_fd * Hdd_inv[:, None]
    H_sc = sys.H_fd.T @ Hfd_w
    b_sc = sys.H_fd.T @ (sys.b_d * Hdd_inv)
    H = sys.H + HM + torch.diag(H_prior_diag) - H_sc
    b = sys.b + bM_eff + b_prior - b_sc
    H = H + lam * torch.diag(torch.diagonal(
        sys.H + HM + torch.diag(H_prior_diag)))

    coord_mask = torch.cat([torch.ones(CPART, dtype=torch.bool, device=dev),
                            frame_mask.repeat_interleave(8)])
    cm = coord_mask.to(H.dtype)
    H = H * cm[:, None] * cm[None, :] + torch.diag(1.0 - cm)
    b = b * cm
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-10))
    Hp = H / (d[:, None] * d[None, :])
    Hp = Hp + 1e-7 * torch.eye(H.shape[0], dtype=H.dtype, device=dev)
    dx = torch.linalg.solve_ex(Hp, -(b / d))[0] / d
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)) * cm
    if N_null is not None:
        dx = orthogonalize_step(dx, N_null)
    dx_d = -(sys.b_d + sys.H_fd @ dx) * Hdd_inv
    return dx, torch.where(point_mask, dx_d, torch.zeros_like(dx_d))


def marginalize_points_system(res: BAResiduals, host, delta, delta_d, pmask,
                              F: int):
    """Fold the points in `pmask` into a (HM, bM0) prior increment
    (marginalizePointsF): their normal equations with the residual shifted
    to the linearization point, idepth Schur-complemented out."""
    Jt = torch.cat([res.J_pose_t, res.J_aff_t], dim=-1)
    Jh = torch.cat([res.J_pose_h, res.J_aff_h], dim=-1)
    d_c = delta[:CPART]
    d_f = delta[CPART:].reshape(F, 8)
    d_h = d_f[host.long()]
    Jdelta = (torch.einsum("fpka,a->fpk", res.J_calib, d_c)
              + torch.einsum("fpka,fa->fpk", Jt, d_f)
              + torch.einsum("fpka,pa->fpk", Jh, d_h))
    r0 = res.r - Jdelta - res.J_dd * delta_d[None, :, None]
    res_m = res._replace(r=r0, wt=res.wt * pmask[None, :, None].to(
        res.wt.dtype))
    sys = accumulate(res_m, host, F)
    Hdd_inv = torch.where(pmask & (sys.H_dd > 1e-8),
                          1.0 / (sys.H_dd + 1e-10),
                          torch.zeros_like(sys.H_dd))
    HM_add = sys.H - sys.H_fd.T @ (sys.H_fd * Hdd_inv[:, None])
    bM_add = sys.b - sys.H_fd.T @ (sys.b_d * Hdd_inv)
    return HM_add, bM_add


def schur_out(HM: torch.Tensor, bM0: torch.Tensor, marg: torch.Tensor):
    """Schur-complement the coordinates in the [C] mask `marg` out of a
    dense prior (eigen pseudo-inverse on the eliminated block), zeroing the
    eliminated rows/cols so slots can be reused."""
    m = marg.to(HM.dtype)
    k = 1.0 - m
    Hbb_f = (m[:, None] * HM * m[None, :]) + torch.diag(k)
    Hbb_f = 0.5 * (Hbb_f + Hbb_f.T)
    evals, evecs = torch.linalg.eigh(Hbb_f)
    inv_evals = torch.where(
        evals > 1e-8 * torch.clamp(torch.amax(torch.abs(evals)), min=1e-12),
        1.0 / evals, torch.zeros_like(evals))
    Hbb_inv = (evecs * inv_evals[None, :]) @ evecs.T
    Hbb_inv = m[:, None] * Hbb_inv * m[None, :]
    HMm = HM * m[None, :]
    HM_new = HM - HMm @ Hbb_inv @ HMm.T
    bM_new = bM0 - HMm @ (Hbb_inv @ (bM0 * m))
    HM_new = HM_new * k[:, None] * k[None, :]
    return 0.5 * (HM_new + HM_new.T), bM_new * k


def marginalize_frame_prior(HM, bM0, slot: int, F: int):
    """Schur-complement one frame's 8 visual coords out of the prior."""
    i0 = CPART + 8 * slot
    idx = torch.arange(HM.shape[0], device=HM.device)
    return schur_out(HM, bM0, (idx >= i0) & (idx < i0 + 8))


def schur_out_np(HM, bM, marg):
    """Host float64 Schur-out with PSD projection (the window prior stays
    float64 on the host: f32 Schur complements of large-magnitude
    information accumulate indefinite error)."""
    m = np.asarray(marg, bool)
    k = ~m
    HM = np.asarray(HM, np.float64)
    bM = np.asarray(bM, np.float64)
    if not (np.all(np.isfinite(HM)) and np.all(np.isfinite(bM))):
        HM = np.nan_to_num(HM, nan=0.0, posinf=0.0, neginf=0.0)
        bM = np.nan_to_num(bM, nan=0.0, posinf=0.0, neginf=0.0)
    Hbb = HM[np.ix_(m, m)]
    Hbb = 0.5 * (Hbb + Hbb.T)
    evals, evecs = np.linalg.eigh(Hbb)
    inv = np.where(evals > 1e-10 * max(evals.max(initial=0.0), 1e-12),
                   1.0 / np.maximum(evals, 1e-300), 0.0)
    Hbb_inv = (evecs * inv) @ evecs.T
    Hkb = HM[np.ix_(k, m)]
    out_H = HM.copy()
    out_b = bM.copy()
    out_H[np.ix_(k, k)] = HM[np.ix_(k, k)] - Hkb @ Hbb_inv @ Hkb.T
    out_b[k] = bM[k] - Hkb @ (Hbb_inv @ bM[m])
    out_H[m, :] = 0.0
    out_H[:, m] = 0.0
    out_b[m] = 0.0
    out_H = 0.5 * (out_H + out_H.T)
    ev, U = np.linalg.eigh(out_H)
    if ev.min() < 0:
        out_H = (U * np.maximum(ev, 0.0)) @ U.T
    return out_H, out_b
