"""Visual-inertial windowed bundle adjustment.

Counterpart of dmvio_tpu/models/vio_ba.py (BAIMULogic + BAGTSAMIntegration):
the keyframe BA state is extended with per-keyframe velocity and biases plus
a global scale and gravity direction, and IMU preintegration factors between
consecutive keyframes are fused into the same damped solve as the
photometric camera system. The DSO-world -> metric-body transform is a
plain differentiable function; forward-mode autodiff (torch.func.jvp over
the local directions, `local_jacobian`) gives every cross-Jacobian (pose,
scale, gravity, extrinsics) for all pairs at once, as jax.vmap(jax.jacfwd)
does in the reference. The reference's on-device `while_loop` is a Python
loop with the same early exit (one host read of `done` per iteration);
every visual linearization goes through `residuals.linearize`, i.e.
kernel K1.

Extended state layout:
    x = [x_vis (4+8F) | per-frame v(3), bg(3), ba(3) -> 9F | s_log, g2(2)]
so C_ext = 4 + 17F + 3, with the same FEJ zero-convention as the visual
stack (delta = current (-) FEJ).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from dmvio_tpu_torch.models import ba as ba_mod
from dmvio_tpu_torch.ops import ba_solve, preint, residuals
from dmvio_tpu_torch.ops.ba_solve import CPART, cdim
from dmvio_tpu_torch.ops.residuals import BAFrames, BAPoints
from dmvio_tpu_torch.parallel import dist_ba
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib

# Relative weight of the photometric system vs the (Mahalanobis-weighted)
# IMU factors: w = 1/sigma_I^2 with sigma_I ~ 8 intensity units
# (setting_dynamicWeightRMSE = 8, IMUSettings.h:63).
W_DSO = 1.0 / 64.0

# Dynamic photometric weight threshold (computeDynamicDSOWeight,
# BAIMULogic.cpp:801-808): above this RMSE the visual system is
# down-weighted by (thresh/rmse)^2.
DYN_RMSE_TH = 8.0

# Residual-floor inflation of the pair covariance (rad, m/s, m).
SIG_FLOOR_ROT = 1e-3
SIG_FLOOR_VEL = 0.01
SIG_FLOOR_POS = 0.003


def cdim_ext(F: int) -> int:
    return cdim(F) + 9 * F + 3


def imu_offset(F: int, f) -> int:
    return cdim(F) + 9 * f


class VIOStates(NamedTuple):
    """Per-frame IMU states + global scale/gravity, with FEJ mirrors."""

    v: torch.Tensor        # [F, 3] metric-world velocity
    bg: torch.Tensor       # [F, 3] gyro bias
    ba: torch.Tensor       # [F, 3] accel bias
    v0: torch.Tensor
    bg0: torch.Tensor
    ba0: torch.Tensor
    s_log: torch.Tensor    # scalar log(scale): p_metric = p_dso / exp(s_log)
    g2: torch.Tensor       # [2] gravity-direction rotation (x, y tangent)
    s_log0: torch.Tensor
    g20: torch.Tensor


class IMUPairs(NamedTuple):
    """Preintegrated measurements between consecutive keyframes.

    Fixed capacity Q = F-1; `i`/`j` are window slots, masked by `valid`."""

    pre: preint.PreintState   # batched [Q, ...]
    i: torch.Tensor           # [Q] int64 older slot
    j: torch.Tensor           # [Q] int64 newer slot
    valid: torch.Tensor       # [Q] bool


class VIOProblem(NamedTuple):
    base: ba_mod.BAProblem        # visual window
    states: VIOStates
    pairs: IMUPairs
    HM: torch.Tensor              # [C_ext, C_ext]
    bM0: torch.Tensor             # [C_ext]
    prior_diag: torch.Tensor      # [C_ext]
    R_cb: torch.Tensor            # [3, 3] cam-from-body extrinsic (T_cam_imu)
    t_cb: torch.Tensor            # [3]
    imu_on: bool                  # fuse IMU factors


def dso_to_body(R_cw, t_cw, s_log, g2, R_cb, t_cb):
    """DSO worldToCam pose -> metric-world body pose (R_wb, p_wb): invert,
    rotate the world by R_g = exp([g2, 0]), unscale the translation and
    append the cam-IMU extrinsic (TransformDSOToIMU). Broadcasts over a
    leading batch axis of the poses."""
    s = torch.exp(s_log)
    R_g = lie.so3_exp(torch.cat([g2, torch.zeros_like(g2[..., :1])], -1))
    R_wc, t_wc = lie.se3_inv(R_cw, t_cw)       # camToWorld (dso)
    R_gT = R_g.transpose(-1, -2)
    R_wc_m = R_gT @ R_wc
    t_wc_m = lie._mv(R_gT, t_wc) / s[..., None]
    R_wb = R_wc_m @ R_cb
    p_wb = lie._mv(R_wc_m, t_cb) + t_wc_m
    return R_wb, p_wb


def local_jacobian(f, z: torch.Tensor) -> torch.Tensor:
    """Jacobian [Q, R, D] of a pair-wise function f: [Q, D] -> [Q, R]
    whose row q depends only on z[q]: forward mode over the D local
    directions, each pushed through all Q pairs at once (torch.func.jvp,
    vmapped over the directions), as jax.vmap(jax.jacfwd) gives it. Forward
    mode keeps the selected branch of every `where` (the sqrt at a zero
    rotation increment); batching over the pairs keeps every traced tensor
    at least one-dimensional."""
    Q, D = z.shape
    basis = torch.eye(D, dtype=z.dtype, device=z.device)[:, None, :] \
        .expand(D, Q, D)
    cols = vmap(lambda t: jvp(f, (z,), (t,))[1])(basis)      # [D, Q, R]
    return cols.permute(1, 2, 0)


def _pair_residual(pre, R_i0, t_i0, R_j0, t_j0, z, R_cb, t_cb,
                   gravity_mag):
    """15-dim weighted residuals [Q, 15] of Q IMU pairs as a function of
    their local increments z [Q, 33] = [xi_i(6), xi_j(6), v_i, v_j, bg_i,
    ba_i, bg_j, ba_j, s_log, g2], evaluated around the given base poses."""
    xi_i, xi_j = z[:, 0:6], z[:, 6:12]
    v_i, v_j = z[:, 12:15], z[:, 15:18]
    b_i = z[:, 18:24]
    b_j = z[:, 24:30]
    s_log = z[:, 30]
    g2 = z[:, 31:33]
    R_i, t_i = lie.se3_retract(R_i0, t_i0, xi_i)
    R_j, t_j = lie.se3_retract(R_j0, t_j0, xi_j)
    Rb_i, pb_i = dso_to_body(R_i, t_i, s_log, g2, R_cb, t_cb)
    Rb_j, pb_j = dso_to_body(R_j, t_j, s_log, g2, R_cb, t_cb)
    r9 = preint.imu_residual(pre, Rb_i, pb_i, v_i, Rb_j, pb_j, v_j, b_i,
                             gravity_mag)
    ones = torch.ones(3, dtype=z.dtype, device=z.device)
    infl = torch.diag(torch.cat([ones * SIG_FLOOR_ROT ** 2,
                                 ones * SIG_FLOOR_VEL ** 2,
                                 ones * SIG_FLOOR_POS ** 2]))
    cov = pre.cov + infl
    L = torch.linalg.cholesky(
        0.5 * (cov + cov.transpose(-1, -2))
        + 1e-12 * torch.eye(9, dtype=z.dtype, device=z.device))
    W9 = torch.linalg.inv(L)
    Wb = preint.bias_walk_sqrt_info(pre.dt)
    return torch.cat([lie._mv(W9, r9), lie._mv(Wb, b_j - b_i)], dim=-1)


def imu_factor_system(frames: BAFrames, states: VIOStates, pairs: IMUPairs,
                      R_cb, t_cb, F: int,
                      gravity_mag: float = preint.GRAVITY):
    """Linearize all keyframe IMU factors into extended-state rows.

    Returns (J_rows [Q, 15, C_ext], r [Q, 15], energy scalar). Jacobians at
    the FEJ mirrors carried in `frames`/`states`; residuals at the current
    state (callers pass mirrors overwritten with the current state, see
    `at_current`, to linearize there). Rows and residuals of invalid pairs
    are zero."""
    si, sj = pairs.i, pairs.j
    Q = si.shape[0]
    zeros12 = torch.zeros(Q, 12, device=si.device)

    def local(v, bg, ba, s_log, g2):
        return torch.cat([
            zeros12, v[si], v[sj], bg[si], ba[si], bg[sj], ba[sj],
            s_log.expand(Q, 1), g2.expand(Q, 2)], dim=1)

    def res_fej(z):
        return _pair_residual(pairs.pre, frames.R0_cw[si], frames.t0_cw[si],
                              frames.R0_cw[sj], frames.t0_cw[sj], z, R_cb,
                              t_cb, gravity_mag)

    J36 = local_jacobian(res_fej, local(states.v0, states.bg0, states.ba0,
                                        states.s_log0, states.g20))
    r = _pair_residual(pairs.pre, frames.R_cw[si], frames.t_cw[si],
                       frames.R_cw[sj], frames.t_cw[sj],
                       local(states.v, states.bg, states.ba, states.s_log,
                             states.g2), R_cb, t_cb, gravity_mag)
    # Invalid (padded) pairs contribute exact zeros: select, never multiply
    # (a NaN from a degenerate pad must not leak).
    vz = pairs.valid
    J36 = torch.where(vz[:, None, None], J36, torch.zeros_like(J36))
    r = torch.where(vz[:, None], r, torch.zeros_like(r))

    # Place the local columns into C_ext with dense slot one-hots (no
    # scatter-adds: deterministic on every device).
    oh_i = torch.nn.functional.one_hot(si, F).to(J36.dtype)   # [Q, F]
    oh_j = torch.nn.functional.one_hot(sj, F).to(J36.dtype)

    def put(blk_i, blk_j):
        return (torch.einsum("qrw,qf->qrfw", blk_i, oh_i)
                + torch.einsum("qrw,qf->qrfw", blk_j, oh_j))

    vis = put(J36[..., 0:6], J36[..., 6:12])               # [Q, 15, F, 6]
    vis = torch.cat([vis, torch.zeros(Q, 15, F, 2, device=vis.device)], -1)
    imu = torch.cat([put(J36[..., 12:15], J36[..., 15:18]),
                     put(J36[..., 18:24], J36[..., 24:30])], -1)
    rows = torch.cat([torch.zeros(Q, 15, CPART, device=vis.device),
                      vis.reshape(Q, 15, 8 * F), imu.reshape(Q, 15, 9 * F),
                      J36[..., 30:33]], dim=-1)
    energy = torch.sum(r * r)
    return rows, r, energy


def at_current(frames: BAFrames, states: VIOStates):
    """FEJ mirrors overwritten with the current state (for linearizing
    active factors at current values, gtsam-style)."""
    return (
        frames._replace(R0_cw=frames.R_cw, t0_cw=frames.t_cw,
                        aff0=frames.aff),
        states._replace(v0=states.v, bg0=states.bg, ba0=states.ba,
                        s_log0=states.s_log, g20=states.g2),
    )


def vio_delta(frames: BAFrames, calib: Calib, calib0, states: VIOStates,
              F: int) -> torch.Tensor:
    """Extended delta = current (-) FEJ over all C_ext coordinates."""
    d_vis = ba_solve.state_delta(frames, calib, calib0)
    d_imu = torch.cat([states.v - states.v0, states.bg - states.bg0,
                       states.ba - states.ba0], dim=-1).reshape(-1)
    d_glob = torch.cat([(states.s_log - states.s_log0)[None],
                        states.g2 - states.g20])
    return torch.cat([d_vis, d_imu, d_glob])


def embed_vis(x_vis: torch.Tensor, F: int) -> torch.Tensor:
    """Pad a visual [Cv] or [Cv, Cv] object into C_ext."""
    pad = cdim_ext(F) - cdim(F)
    if x_vis.dim() == 1:
        return torch.nn.functional.pad(x_vis, (0, pad))
    return torch.nn.functional.pad(x_vis, (0, pad, 0, pad))


class VIOResult(NamedTuple):
    frames: BAFrames
    points: BAPoints
    calib: Calib
    states: VIOStates
    energy: torch.Tensor
    imu_energy: torch.Tensor
    iters: torch.Tensor
    pair_outlier: torch.Tensor
    pair_energy: torch.Tensor
    vis_rmse: torch.Tensor     # photometric RMSE at solve entry
    dyn_weight: torch.Tensor   # dynamic DSO weight applied (<= 1)
    frame_th: torch.Tensor     # [F] adaptive per-frame energy threshold


def optimize(problem: VIOProblem, images: torch.Tensor,
             max_iters: int = 6, w_dso: float = W_DSO) -> VIOResult:
    """Joint visual-inertial LM over the extended window state: embed the
    point-reduced photometric system, add the IMU factor system and the
    priors, solve jointly, retract (computeBAUpdate). `problem` and
    `images` may be placed by a dist_ba.Placer (place_vio): the visual
    point axis then runs per shard, the IMU block once."""
    S = ba_mod._Shards(_bases(problem), images)
    prob0 = dist_ba.unplace(problem)[0][0]
    base = S.parts[0]
    F = base.frames.mask.shape[0]
    C = cdim_ext(F)
    Cv = cdim(F)
    dev = base.frames.R_cw.device
    imu_on = bool(prob0.imu_on)

    geos = [residuals.fej_geometry(p.frames, p.points, p.calib)
            for p in S.parts]

    def lin_vis(frames, points, calib):
        return S.linearize(frames, points, calib, geos)

    def photo(lins):
        return S.sum(torch.sum(ln.energy) for ln in lins)

    def energies(frames, calib, states, e_photo):
        delta = vio_delta(frames, calib, base.calib0, states, F)
        e_m = delta @ (2.0 * prob0.bM0 + prob0.HM @ delta)
        e_p = delta @ (prob0.prior_diag * delta)
        _, _, e_imu = imu_factor_system(
            frames._replace(R0_cw=frames.R_cw, t0_cw=frames.t_cw),
            states, prob0.pairs, prob0.R_cb, prob0.t_cb, F)
        if not imu_on:
            e_imu = torch.zeros_like(e_imu)
        return w_eff * e_photo + e_imu + e_m + e_p, e_imu

    frames, calib = base.frames, base.calib
    points = tuple(p.points for p in S.parts)
    pmasks = tuple(p.mask for p in points)
    lin0 = lin_vis(frames, points, calib)
    # Dynamic photometric weight from the initial linearization (one RMSE
    # over every shard), fixed for the whole solve so the LM objective
    # stays consistent.
    n_px = torch.clamp(S.sum(torch.sum(ln.active.to(torch.float32))
                             for ln in lin0), min=1.0)
    e_photo0 = photo(lin0)
    rmse0 = torch.sqrt(e_photo0 / n_px)
    dyn = torch.where(rmse0 > DYN_RMSE_TH,
                      (DYN_RMSE_TH / torch.clamp(rmse0, min=1e-6)) ** 2,
                      torch.ones_like(rmse0))
    w_eff = w_dso * dyn if imu_on else w_dso * torch.ones_like(rmse0)

    states = prob0.states
    energy, imu_energy = energies(frames, calib, states, e_photo0)
    sys_v = ba_solve.accumulate_shards(lin0, [p.host for p in points], F,
                                       S.sh)
    lam = torch.tensor(1e-4, device=dev)

    # Coordinate mask: unoccupied frames; IMU coords gated by imu_on.
    fm = frames.mask
    cm = torch.cat([torch.ones(CPART, dtype=torch.bool, device=dev),
                    torch.repeat_interleave(fm, 8),
                    torch.repeat_interleave(fm, 9) & imu_on,
                    torch.full((3,), imu_on, device=dev)]).to(torch.float32)
    eye_C = torch.eye(C, device=dev)
    it = 0
    while it < max_iters:
        delta = vio_delta(frames, calib, base.calib0, states, F)
        # Point-Schur on the visual system (each shard's partial summed),
        # then embed into C_ext.
        H_sc, b_sc, Hdd_inv = ba_solve.point_schur(sys_v, lam, pmasks, S.sh)
        H_vis = (sys_v.H - H_sc) * w_eff
        b_vis = (sys_v.b - b_sc) * w_eff

        fr_cur, st_cur = at_current(frames, states)
        rows, r_imu, _ = imu_factor_system(
            fr_cur, st_cur, prob0.pairs, prob0.R_cb, prob0.t_cb, F)
        Jf = rows.reshape(-1, C)
        if imu_on:
            H_imu = Jf.T @ Jf
            b_imu = Jf.T @ r_imu.reshape(-1)
        else:
            H_imu = torch.zeros(C, C, device=dev)
            b_imu = torch.zeros(C, device=dev)

        H = embed_vis(H_vis, F) + H_imu + prob0.HM \
            + torch.diag(prob0.prior_diag)
        b = embed_vis(b_vis, F) + b_imu + prob0.bM0 \
            + prob0.HM @ delta + prob0.prior_diag * delta
        H = H + lam * torch.diag(torch.diagonal(H))
        H = H * cm[:, None] * cm[None, :] + torch.diag(1.0 - cm)
        b = b * cm

        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-10))
        Hp = H / (d[:, None] * d[None, :]) + 1e-7 * eye_C
        dx = torch.linalg.solve_ex(Hp, -(b / d))[0] / d
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)) * cm

        # Back-substitute idepths from the visual part of the step, per
        # shard.
        dx_vis = dx[:Cv]
        dx_d = [ba_solve.back_substitute(H_fd, b_d, hi, pm, dxk)
                for H_fd, b_d, hi, pm, dxk in zip(
                    sys_v.H_fd, sys_v.b_d, Hdd_inv, pmasks,
                    S.sh.copies(dx_vis))]

        frames_n, calib_n = ba_mod._apply_step(frames, calib, dx_vis, F)
        points_n = tuple(ba_mod._step_points(p, dd)
                         for p, dd in zip(points, dx_d))
        d_imu = dx[Cv:Cv + 9 * F].reshape(F, 9)
        states_n = states._replace(
            v=states.v + d_imu[:, 0:3], bg=states.bg + d_imu[:, 3:6],
            ba=states.ba + d_imu[:, 6:9],
            s_log=states.s_log + dx[Cv + 9 * F],
            g2=states.g2 + dx[Cv + 9 * F + 1:Cv + 9 * F + 3])

        lin_n = lin_vis(frames_n, points_n, calib_n)
        e_n, ei_n = energies(frames_n, calib_n, states_n, photo(lin_n))
        accept = (e_n < energy) & torch.isfinite(e_n)
        step_sq = torch.sum(dx * dx)
        # Small-step or flat-step termination in either direction (the
        # reference's canbreak, FullSystemOptimize.cpp:550-586).
        done = (step_sq < 1e-12) | (lam > 1e4) \
            | (torch.abs(energy - e_n)
               < 2e-4 * torch.clamp(energy, min=1e-12))
        sys_n = ba_solve.accumulate_shards(
            lin_n, [p.host for p in points_n], F, S.sh)
        frames = ba_mod._select(accept, frames_n, frames)
        points = ba_mod._select(accept, points_n, points)
        calib = ba_mod._select(accept, calib_n, calib)
        states = ba_mod._select(accept, states_n, states)
        sys_v = ba_mod._select(accept, sys_n, sys_v)
        energy = torch.where(accept, e_n, energy)
        imu_energy = torch.where(accept, ei_n, imu_energy)
        lam = torch.where(accept, torch.clamp(lam * 0.25, min=1e-6),
                          lam * 4.0)
        it += 1
        if bool(done):          # the one host read per LM iteration
            break

    # Final-state linearization for outlier classification.
    lin_f = lin_vis(frames, points, calib)
    out = ba_mod._classify(S, frames, points, calib, lin_f, None, it,
                           VIOResult, states=states, imu_energy=imu_energy,
                           vis_rmse=rmse0, dyn_weight=dyn)
    return out._replace(energy=torch.sum(out.pair_energy))


def _bases(problem):
    """The visual window problem of a (possibly placed) VIOProblem."""
    if isinstance(problem, dist_ba.Placed):
        return dist_ba.Placed([p.base for p in problem.parts],
                              problem.placer)
    return problem.base


def vio_marg_fused(problem: VIOProblem, images: torch.Tensor,
                   age_rank: torch.Tensor, n_drop, newest_slot: int):
    """The VIO keyframe marginalization tail: victim selection, extended
    point-marginalization fold, the victims' IMU pair-factor fold
    (victim-touching pairs selected on the device) and the point drops.
    With n_drop == 0 everything degenerates to zeros / no-ops.

    Returns (vlist [F], HM_add, bM_add, fold_H, fold_b, points_new,
    pair_mask_new, n_active_pre, n_active_post)."""
    prob0 = dist_ba.unplace(problem)[0][0]
    base = prob0.base
    F = base.frames.mask.shape[0]
    (vlist, HM_add, bM_add, points_new, pm_new, n_pre,
     n_post) = ba_mod.marg_fused(_bases(problem), images, age_rank, n_drop,
                                 newest_slot)
    is_v_i = torch.any(prob0.pairs.i[:, None] == vlist[None, :], dim=1)
    is_v_j = torch.any(prob0.pairs.j[:, None] == vlist[None, :], dim=1)
    sel = prob0.pairs.valid & (is_v_i | is_v_j)
    fold_H, fold_b = fold_pairs_into_prior(
        base.frames, prob0.states, prob0.pairs, prob0.R_cb, prob0.t_cb,
        base.calib, base.calib0, F, sel)
    return (vlist, embed_vis(HM_add * W_DSO, F), embed_vis(bM_add * W_DSO, F),
            fold_H, fold_b, points_new, pm_new, n_pre, n_post)


def fold_pairs_into_prior(frames: BAFrames, states: VIOStates,
                          pairs: IMUPairs, R_cb, t_cb, calib: Calib, calib0,
                          F: int, pair_sel: torch.Tensor):
    """Fold selected IMU pair factors into (HM, bM0) before their frames
    are marginalized (marginalizeBAFrame, BAGTSAMIntegration.cpp:370-396):
    FEJ Jacobians, residual transported to the linearization point
    (r0 = r - J delta)."""
    C = cdim_ext(F)
    rows, r, _ = imu_factor_system(frames, states, pairs, R_cb, t_cb, F)
    rows = torch.where(pair_sel[:, None, None], rows, torch.zeros_like(rows))
    r = torch.where(pair_sel[:, None], r, torch.zeros_like(r))
    delta = vio_delta(frames, calib, calib0, states, F)
    Jf = rows.reshape(-1, C)
    r0 = r.reshape(-1) - Jf @ delta
    return Jf.T @ Jf, Jf.T @ r0


def schur_out_np(HM: np.ndarray, bM: np.ndarray, marg: np.ndarray):
    """Host float64 Schur-out with PSD projection (a copy of the
    reference's). The prior carries pair-factor information of magnitude
    ~1e8; float32 Schur complements of such terms leave indefinite garbage
    that accumulates across keyframes, so this stays host float64."""
    m = np.asarray(marg, bool)
    k = ~m
    HM = np.asarray(HM, np.float64)
    bM = np.asarray(bM, np.float64)
    if not (np.all(np.isfinite(HM)) and np.all(np.isfinite(bM))):
        # A poisoned prior must not crash the eigensolver: drop the
        # non-finite information and let the reset machinery recover.
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
    # PSD projection: clip small negative eigenvalues (roundoff defense).
    ev, U = np.linalg.eigh(out_H)
    if ev.min() < 0:
        out_H = (U * np.maximum(ev, 0.0)) @ U.T
    return out_H, out_b


def frame_marg_mask(slot: int, F: int, device) -> torch.Tensor:
    """Extended-coordinate mask of one frame (8 visual + 9 IMU coords)."""
    idx = torch.arange(cdim_ext(F), device=device)
    i0 = CPART + 8 * slot
    j0 = imu_offset(F, slot)
    return ((idx >= i0) & (idx < i0 + 8)) | ((idx >= j0) & (idx < j0 + 9))
