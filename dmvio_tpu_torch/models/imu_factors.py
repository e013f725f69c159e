# Copy of dmvio_tpu/models/imu_factors.py (NumPy only): the port keeps its own
# copy so that it imports nothing of the JAX package.
"""Host float64 IMU preintegration factor: residual + ANALYTIC Jacobians.

The delayed-marginalization log, PGBA, and the coarse filter all linearize
the same 15-dim preintegration residual between two keyframes/frames on the
host in float64 (see models/vio_coarse.py for the host/f64 rationale). This
module is the single analytic implementation; round 1 used finite
differences (34 residual evaluations per pair per LM iteration), which
does not scale to the reference's delay=100 window
(src/IMUInitialization/IMUInitSettings.h:62) at realtime cadence.

Residual convention (matches gtsam::ImuFactor semantics the reference uses
via PoseTransformationFactor, PoseTransformationIMU.h:45-133):

    r_R = Log( dR(bg_i)^T Rb_i^T Rb_j )
    r_v = Rb_i^T (v_j - v_i - g dt) - dv(bg_i, ba_i)
    r_p = Rb_i^T (pb_j - pb_i - v_i dt - 1/2 g dt^2) - dp(bg_i, ba_i)
    r_b = [bg_j - bg_i; ba_j - ba_i]

where (Rb, pb) = dso_to_body(R_cw, t_cw, s, R_g, R_cb, t_cb) carries the
full TransformDSOToIMU chain: DSO worldToCam -> metric (scale s, gravity
rotation R_g, z-fixed) -> body via the camera-IMU extrinsics (R_cb, t_cb).

State perturbation (all LEFT-increment on the DSO pose, matching
utils/lie / delayed._state_delta):
    z = [ds(1), dg2(2),
         xi_i(6: v,w), dv_i(3), dbg_i(3), dba_i(3),    # i-block (15)
         xi_j(6: v,w), dv_j(3), dbg_j(3), dba_j(3)]    # j-block (15)
"""

from __future__ import annotations

import numpy as np

GRAVITY = 9.8082


class FrameState:
    """Minimal (R_cw, t_cw, v, bg, ba) carrier for linearize_pair callers
    that do not hold a delayed.KFState."""

    __slots__ = ("R_cw", "t_cw", "v", "bg", "ba")

    def __init__(self, R_cw, t_cw, v, bg, ba):
        self.R_cw, self.t_cw, self.v, self.bg, self.ba = R_cw, t_cw, v, bg, ba


def _hat(w):
    return np.array([[0.0, -w[2], w[1]],
                     [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def _exp_so3(w):
    t = np.linalg.norm(w)
    W = _hat(w)
    if t < 1e-9:
        return np.eye(3) + W + 0.5 * W @ W
    return (np.eye(3) + np.sin(t) / t * W
            + (1 - np.cos(t)) / (t * t) * W @ W)


def _log_so3(R):
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    anti = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_t = 0.5 * np.linalg.norm(anti)
    t = np.arctan2(sin_t, cos_t)
    if sin_t < 1e-8:
        return 0.5 * anti
    return anti * (0.5 * t / sin_t)


def _jl_so3(w):
    """Left Jacobian of SO(3)."""
    t = np.linalg.norm(w)
    W = _hat(w)
    if t < 1e-6:
        return np.eye(3) + 0.5 * W + W @ W / 6.0
    return (np.eye(3) + (1 - np.cos(t)) / (t * t) * W
            + (t - np.sin(t)) / (t ** 3) * W @ W)


def _jr_so3(w):
    """Right Jacobian: Jr(w) = Jl(-w)."""
    return _jl_so3(-np.asarray(w))


def _jr_inv_so3(r):
    """Inverse right Jacobian of SO(3) at r."""
    t = np.linalg.norm(r)
    W = _hat(r)
    if t < 1e-6:
        return np.eye(3) + 0.5 * W + W @ W / 12.0
    return (np.eye(3) + 0.5 * W
            + (1.0 / (t * t) - (1 + np.cos(t)) / (2 * t * np.sin(t)))
            * (W @ W))


def _jl_inv_so3(r):
    return _jr_inv_so3(-np.asarray(r))


def _dso_to_body(R_cw, t_cw, s, R_g, R_cb, t_cb):
    R_wc = R_cw.T
    t_wc = -R_wc @ t_cw
    R_wb = R_g.T @ R_wc @ R_cb
    p_wb = R_g.T @ R_wc @ t_cb + (R_g.T @ t_wc) / s
    return R_wb, p_wb


class _FrameMaps:
    """Derivative maps of one frame's body pose wrt its perturbations."""

    def __init__(self, R_cw, t_cw, s, R_g, Jlw2, R_cb, t_cb):
        self.Rb, self.pb = _dso_to_body(R_cw, t_cw, s, R_g, R_cb, t_cb)
        R_wc = R_cw.T
        t_wc = -R_wc @ t_cw
        M = R_g.T @ R_wc
        # Pose xi = (v, w), LEFT-increment on T_cw => T_wc <- T_wc Exp(-xi):
        #   Rb <- Rb Exp(dtheta),  dtheta = -R_cb^T w
        #   pb <- pb - (M v)/s + M [t_cb]x w
        self.Dth_w = -R_cb.T
        self.Dp_v = -M / s
        self.Dp_w = M @ _hat(t_cb)
        # Scale (ds = d s_log): pb metric part shrinks with s.
        self.Dp_s = -(R_g.T @ t_wc) / s
        # Gravity tangent g2: R_g <- Exp(Jl(w_g) [dg2, 0]) R_g.
        #   dtheta = -Rb^T R_g^T Jlw2 dg2;  dpb = R_g^T [R_g pb]x Jlw2 dg2
        self.Dth_g = -self.Rb.T @ R_g.T @ Jlw2
        self.Dp_g = R_g.T @ _hat(R_g @ self.pb) @ Jlw2


def linearize_pair(sti, stj, pre, s_log, g2, R_cb, t_cb):
    """Residual + analytic Jacobian of one preintegration pair.

    sti/stj: objects with R_cw, t_cw, v, bg, ba (host float64).
    pre:     host preintegration dict (ops/preint.preintegrate_np fields).
    Returns (r_raw [15], J_raw [15, 33]) — UNWEIGHTED; callers apply their
    sqrt-information.
    """
    s = float(np.exp(s_log))
    w_g = np.array([g2[0], g2[1], 0.0], np.float64)
    R_g = _exp_so3(w_g)
    Jlw2 = _jl_so3(w_g)[:, :2]
    g_vec = np.array([0.0, 0.0, -GRAVITY])
    dt = float(pre["dt"])

    fi = _FrameMaps(np.asarray(sti.R_cw, np.float64),
                    np.asarray(sti.t_cw, np.float64), s, R_g, Jlw2,
                    np.asarray(R_cb, np.float64),
                    np.asarray(t_cb, np.float64))
    fj = _FrameMaps(np.asarray(stj.R_cw, np.float64),
                    np.asarray(stj.t_cw, np.float64), s, R_g, Jlw2,
                    np.asarray(R_cb, np.float64),
                    np.asarray(t_cb, np.float64))

    bg_i = np.asarray(sti.bg, np.float64)
    ba_i = np.asarray(sti.ba, np.float64)
    dbg = bg_i - np.asarray(pre["bias_lin"][:3], np.float64)
    dba = ba_i - np.asarray(pre["bias_lin"][3:6], np.float64)
    J_Rbg = np.asarray(pre["dR_dbg"], np.float64)
    dR = np.asarray(pre["dR"], np.float64) @ _exp_so3(J_Rbg @ dbg)
    dv = (np.asarray(pre["dv"], np.float64)
          + np.asarray(pre["dv_dbg"], np.float64) @ dbg
          + np.asarray(pre["dv_dba"], np.float64) @ dba)
    dp = (np.asarray(pre["dp"], np.float64)
          + np.asarray(pre["dp_dbg"], np.float64) @ dbg
          + np.asarray(pre["dp_dba"], np.float64) @ dba)

    Rbi, pbi = fi.Rb, fi.pb
    Rbj, pbj = fj.Rb, fj.pb
    v_i = np.asarray(sti.v, np.float64)
    v_j = np.asarray(stj.v, np.float64)

    E = dR.T @ Rbi.T @ Rbj
    r_R = _log_so3(E)
    u_v = v_j - v_i - g_vec * dt
    r_v = Rbi.T @ u_v - dv
    q = pbj - pbi - v_i * dt - 0.5 * g_vec * dt ** 2
    r_p = Rbi.T @ q - dp
    r_b = np.concatenate([np.asarray(stj.bg, np.float64) - bg_i,
                          np.asarray(stj.ba, np.float64) - ba_i])
    r = np.concatenate([r_R, r_v, r_p, r_b])

    # ---- Jacobian assembly ------------------------------------------------
    J = np.zeros((15, 33))
    # Column layout.
    DS = slice(0, 1)
    DG = slice(1, 3)
    VI, WI = slice(3, 6), slice(6, 9)
    DVI, DBGI, DBAI = slice(9, 12), slice(12, 15), slice(15, 18)
    VJ, WJ = slice(18, 21), slice(21, 24)
    DVJ, DBGJ, DBAJ = slice(24, 27), slice(27, 30), slice(30, 33)

    Jr_inv = _jr_inv_so3(r_R)
    Jl_inv = Jr_inv.T            # Jl^{-1}(r) = Jr^{-1}(r)^T
    RjTRi = Rbj.T @ Rbi

    # r_R rows: dtheta_i enters via E Exp(-Rbj^T Rbi dtheta_i), dtheta_j via
    # E Exp(dtheta_j), bias via Exp(-B dbg) E with B = Jr(J_Rbg dbg) J_Rbg.
    A_i = -Jr_inv @ RjTRi        # d r_R / d theta_i
    A_j = Jr_inv                 # d r_R / d theta_j
    B = _jr_so3(J_Rbg @ dbg) @ J_Rbg
    J[0:3, WI] = A_i @ fi.Dth_w
    J[0:3, WJ] = A_j @ fj.Dth_w
    J[0:3, DG] = A_i @ fi.Dth_g + A_j @ fj.Dth_g
    J[0:3, DBGI] = -Jl_inv @ B

    # r_v rows.
    Ru = _hat(Rbi.T @ u_v)       # d(Rbi^T u)/d theta_i = [Rbi^T u]x
    J[3:6, WI] = Ru @ fi.Dth_w
    J[3:6, DG] = Ru @ fi.Dth_g
    J[3:6, DVI] = -Rbi.T
    J[3:6, DVJ] = Rbi.T
    J[3:6, DBGI] = -np.asarray(pre["dv_dbg"], np.float64)
    J[3:6, DBAI] = -np.asarray(pre["dv_dba"], np.float64)

    # r_p rows.
    Rq = _hat(Rbi.T @ q)
    J[6:9, WI] = Rq @ fi.Dth_w + (-Rbi.T) @ fi.Dp_w
    J[6:9, VI] = (-Rbi.T) @ fi.Dp_v
    J[6:9, WJ] = Rbi.T @ fj.Dp_w
    J[6:9, VJ] = Rbi.T @ fj.Dp_v
    J[6:9, DS] = (Rbi.T @ (fj.Dp_s - fi.Dp_s))[:, None]
    J[6:9, DG] = Rq @ fi.Dth_g + Rbi.T @ (fj.Dp_g - fi.Dp_g)
    J[6:9, DVI] = -Rbi.T * dt
    J[6:9, DBGI] = -np.asarray(pre["dp_dbg"], np.float64)
    J[6:9, DBAI] = -np.asarray(pre["dp_dba"], np.float64)

    # r_b rows.
    J[9:12, DBGI] = -np.eye(3)
    J[9:12, DBGJ] = np.eye(3)
    J[12:15, DBAI] = -np.eye(3)
    J[12:15, DBAJ] = np.eye(3)

    return r, J


# ---------------------------------------------------------------------------
# Batched (vectorized) linearization over N pairs.
#
# PGBA relinearizes ~100 pairs per LM iteration (delay=100,
# IMUInitSettings.h:62); the scalar path above costs ~0.25 ms/pair of
# small-matrix Python overhead — ~30 ms/iteration of GIL-holding host work
# that stalls the realtime pipeline even from the background PGBA thread.
# The batch path below computes the SAME formulas over [N, ...] stacks
# (np.matmul broadcasting keeps the per-element contraction order of the
# 3x3 products, so results match the scalar path to the last ulp in
# practice; tests/test_imu_factors.py asserts agreement at 1e-13).
# ---------------------------------------------------------------------------

def _hat_b(w):
    """[N,3] -> [N,3,3]."""
    N = w.shape[0]
    W = np.zeros((N, 3, 3), np.float64)
    W[:, 0, 1] = -w[:, 2]
    W[:, 0, 2] = w[:, 1]
    W[:, 1, 0] = w[:, 2]
    W[:, 1, 2] = -w[:, 0]
    W[:, 2, 0] = -w[:, 1]
    W[:, 2, 1] = w[:, 0]
    return W


def _exp_so3_b(w):
    t = np.linalg.norm(w, axis=-1)           # [N]
    W = _hat_b(w)
    W2 = W @ W
    small = t < 1e-9
    ts = np.where(small, 1.0, t)
    c1 = np.where(small, 1.0, np.sin(ts) / ts)
    c2 = np.where(small, 0.5, (1 - np.cos(ts)) / (ts * ts))
    return (np.eye(3) + c1[:, None, None] * W + c2[:, None, None] * W2)


def _log_so3_b(R):
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos_t = np.clip((tr - 1) / 2, -1, 1)
    anti = np.stack([R[:, 2, 1] - R[:, 1, 2],
                     R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], axis=-1)
    sin_t = 0.5 * np.linalg.norm(anti, axis=-1)
    t = np.arctan2(sin_t, cos_t)
    small = sin_t < 1e-8
    scale = np.where(small, 0.5, 0.5 * t / np.where(small, 1.0, sin_t))
    return anti * scale[:, None]


def _jl_so3_b(w):
    t = np.linalg.norm(w, axis=-1)
    W = _hat_b(w)
    W2 = W @ W
    small = t < 1e-6
    ts = np.where(small, 1.0, t)
    c1 = np.where(small, 0.5, (1 - np.cos(ts)) / (ts * ts))
    c2 = np.where(small, 1.0 / 6.0, (ts - np.sin(ts)) / (ts ** 3))
    return np.eye(3) + c1[:, None, None] * W + c2[:, None, None] * W2


def _jr_so3_b(w):
    return _jl_so3_b(-np.asarray(w))


def _jr_inv_so3_b(r):
    t = np.linalg.norm(r, axis=-1)
    W = _hat_b(r)
    W2 = W @ W
    small = t < 1e-6
    ts = np.where(small, 1.0, t)
    c2 = np.where(small, 1.0 / 12.0,
                  1.0 / (ts * ts)
                  - (1 + np.cos(ts)) / (2 * ts * np.sin(ts)))
    return np.eye(3) + 0.5 * W + c2[:, None, None] * W2


class PairBatch:
    """Stacked pre-integration fields + per-pair state indices.

    Built once per PGBA run (the pre fields and sqrt-information weights
    never change across LM iterations); states are passed per-linearize as
    stacked arrays indexed by ii/jj."""

    __slots__ = ("n", "ii", "jj", "dR", "dv", "dp", "dt", "dR_dbg",
                 "dv_dbg", "dv_dba", "dp_dbg", "dp_dba", "bias_lin",
                 "W9", "Wb")

    def __init__(self, pres, ii, jj, W9, Wb):
        self.n = len(pres)
        self.ii = np.asarray(ii, np.int64)
        self.jj = np.asarray(jj, np.int64)
        for f in ("dR", "dv", "dp", "dR_dbg", "dv_dbg", "dv_dba",
                  "dp_dbg", "dp_dba", "bias_lin"):
            setattr(self, f, np.stack([np.asarray(p[f], np.float64)
                                       for p in pres]))
        self.dt = np.asarray([float(p["dt"]) for p in pres], np.float64)
        self.W9 = W9      # [N,9,9] sqrt-information of [r_R, r_v, r_p]
        self.Wb = Wb      # [N,6,6] sqrt-information of the bias walk


def _frame_maps_b(R_cw, t_cw, s, R_g, Jlw2, R_cb, t_cb):
    """Batched _FrameMaps: returns (Rb, pb, Dth_w, Dp_v, Dp_w, Dp_s,
    Dth_g, Dp_g) with leading [N] axis."""
    R_wc = np.swapaxes(R_cw, -1, -2)
    t_wc = -(R_wc @ t_cw[..., None])[..., 0]
    M = R_g.T @ R_wc                       # [N,3,3] (broadcast 3x3 @ N,3,3)
    Rb = M @ R_cb
    pb = ((M @ t_cb[None, :, None])[..., 0]
          + (R_g.T @ t_wc[..., None])[..., 0] / s)
    Dth_w = np.broadcast_to(-R_cb.T, Rb.shape)
    Dp_v = -M / s
    Dp_w = M @ _hat(t_cb)
    Dp_s = -(R_g.T @ t_wc[..., None])[..., 0] / s
    Dth_g = -np.swapaxes(Rb, -1, -2) @ (R_g.T @ Jlw2)
    Dp_g = R_g.T @ (_hat_b((R_g @ pb[..., None])[..., 0]) @ Jlw2)
    return Rb, pb, Dth_w, Dp_v, Dp_w, Dp_s, Dth_g, Dp_g


def linearize_pairs_batch(batch: PairBatch, R_cw, t_cw, v, bg, ba,
                          s_log, g2, R_cb, t_cb, want_jac=True):
    """Vectorized residual (+ Jacobian) of all pairs in `batch`.

    R_cw [K,3,3], t_cw/v/bg/ba [K,3]: stacked states over the PGBA
    keyframe set; batch.ii/jj index into them. Returns (r [N,15],
    J [N,15,33] or None). Same math as linearize_pair."""
    s = float(np.exp(s_log))
    w_g = np.array([g2[0], g2[1], 0.0], np.float64)
    R_g = _exp_so3(w_g)
    Jlw2 = _jl_so3(w_g)[:, :2]
    g_vec = np.array([0.0, 0.0, -GRAVITY])
    R_cb = np.asarray(R_cb, np.float64)
    t_cb = np.asarray(t_cb, np.float64)

    ii, jj = batch.ii, batch.jj
    (Rbi, pbi, Dth_w_i, Dp_v_i, Dp_w_i, Dp_s_i, Dth_g_i, Dp_g_i) = \
        _frame_maps_b(R_cw[ii], t_cw[ii], s, R_g, Jlw2, R_cb, t_cb)
    (Rbj, pbj, Dth_w_j, Dp_v_j, Dp_w_j, Dp_s_j, Dth_g_j, Dp_g_j) = \
        _frame_maps_b(R_cw[jj], t_cw[jj], s, R_g, Jlw2, R_cb, t_cb)

    bg_i, ba_i = bg[ii], ba[ii]
    dbg = bg_i - batch.bias_lin[:, :3]
    dba = ba_i - batch.bias_lin[:, 3:6]
    J_Rbg = batch.dR_dbg
    corr = (J_Rbg @ dbg[..., None])[..., 0]
    dR = batch.dR @ _exp_so3_b(corr)
    dv = (batch.dv + (batch.dv_dbg @ dbg[..., None])[..., 0]
          + (batch.dv_dba @ dba[..., None])[..., 0])
    dp = (batch.dp + (batch.dp_dbg @ dbg[..., None])[..., 0]
          + (batch.dp_dba @ dba[..., None])[..., 0])

    RbiT = np.swapaxes(Rbi, -1, -2)
    dt = batch.dt[:, None]
    E = np.swapaxes(dR, -1, -2) @ RbiT @ Rbj
    r_R = _log_so3_b(E)
    u_v = v[jj] - v[ii] - g_vec * dt
    r_v = (RbiT @ u_v[..., None])[..., 0] - dv
    q = pbj - pbi - v[ii] * dt - 0.5 * g_vec * dt ** 2
    r_p = (RbiT @ q[..., None])[..., 0] - dp
    r_b = np.concatenate([bg[jj] - bg_i, ba[jj] - ba_i], axis=-1)
    r = np.concatenate([r_R, r_v, r_p, r_b], axis=-1)
    if not want_jac:
        return r, None

    N = batch.n
    J = np.zeros((N, 15, 33))
    DS = slice(0, 1)
    DG = slice(1, 3)
    VI, WI = slice(3, 6), slice(6, 9)
    DVI, DBGI, DBAI = slice(9, 12), slice(12, 15), slice(15, 18)
    VJ, WJ = slice(18, 21), slice(21, 24)
    DVJ, DBGJ, DBAJ = slice(24, 27), slice(27, 30), slice(30, 33)

    Jr_inv = _jr_inv_so3_b(r_R)
    Jl_inv = np.swapaxes(Jr_inv, -1, -2)
    RjTRi = np.swapaxes(Rbj, -1, -2) @ Rbi

    A_i = -Jr_inv @ RjTRi
    A_j = Jr_inv
    B = _jr_so3_b(corr) @ J_Rbg
    J[:, 0:3, WI] = A_i @ Dth_w_i
    J[:, 0:3, WJ] = A_j @ Dth_w_j
    J[:, 0:3, DG] = A_i @ Dth_g_i + A_j @ Dth_g_j
    J[:, 0:3, DBGI] = -Jl_inv @ B

    Ru = _hat_b((RbiT @ u_v[..., None])[..., 0])
    J[:, 3:6, WI] = Ru @ Dth_w_i
    J[:, 3:6, DG] = Ru @ Dth_g_i
    J[:, 3:6, DVI] = -RbiT
    J[:, 3:6, DVJ] = RbiT
    J[:, 3:6, DBGI] = -batch.dv_dbg
    J[:, 3:6, DBAI] = -batch.dv_dba

    Rq = _hat_b((RbiT @ q[..., None])[..., 0])
    J[:, 6:9, WI] = Rq @ Dth_w_i + (-RbiT) @ Dp_w_i
    J[:, 6:9, VI] = (-RbiT) @ Dp_v_i
    J[:, 6:9, WJ] = RbiT @ Dp_w_j
    J[:, 6:9, VJ] = RbiT @ Dp_v_j
    J[:, 6:9, DS] = (RbiT @ (Dp_s_j - Dp_s_i)[..., None])
    J[:, 6:9, DG] = Rq @ Dth_g_i + RbiT @ (Dp_g_j - Dp_g_i)
    J[:, 6:9, DVI] = -RbiT * dt[..., None]
    J[:, 6:9, DBGI] = -batch.dp_dbg
    J[:, 6:9, DBAI] = -batch.dp_dba

    J[:, 9:12, DBGI] = -np.eye(3)
    J[:, 9:12, DBGJ] = np.eye(3)
    J[:, 12:15, DBAI] = -np.eye(3)
    J[:, 12:15, DBAJ] = np.eye(3)
    return r, J
