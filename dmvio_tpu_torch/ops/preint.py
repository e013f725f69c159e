"""On-manifold IMU preintegration.

Counterpart of dmvio_tpu/ops/preint.py: Forster-style preintegrated
dR/dv/dp with first-order bias Jacobians and 9x9 covariance propagation
(the used subset of GTSAM's PreintegratedImuMeasurements). The reference's
`lax.scan` over padded samples is a Python loop over samples here
(`preintegrate`); dt = 0 rows are exact no-ops. The main path preintegrates
on the host in float64 (`preintegrate_np`, a copy of the reference's) and
uploads the result with `state_from_np`; the device loop serves parity and
callers that want it.

Conventions as the reference: body frame = IMU frame, R = R_wb, gravity
-z in the metric world, bias = [bg (3), ba (3)], residual ordering
[r_R, r_v, r_p]. The residual functions broadcast over leading batch axes
of the PreintState fields.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dmvio_tpu_torch.utils import lie

GRAVITY = 9.8082  # reference IMUCalibration default (IMUSettings.h:126-135)


class NoiseModel:
    """Process-wide IMU noise model (continuous-time densities), set once
    per run by `set_noise` (IMUSystem's constructor does it)."""

    sigma_gyro: float = 1.6968e-4
    sigma_acc: float = 2.0e-3
    sigma_gyro_walk: float = 8.0e-5
    sigma_acc_walk: float = 3.0e-3
    sigma_integration: float = 1e-8


NOISE = NoiseModel()


def set_noise(sigma_gyro=None, sigma_acc=None, sigma_gyro_walk=None,
              sigma_acc_walk=None, sigma_integration=None) -> None:
    """Install dataset noise densities (call before the first frame)."""
    for k, v in [("sigma_gyro", sigma_gyro), ("sigma_acc", sigma_acc),
                 ("sigma_gyro_walk", sigma_gyro_walk),
                 ("sigma_acc_walk", sigma_acc_walk),
                 ("sigma_integration", sigma_integration)]:
        if v is not None:
            setattr(NOISE, k, float(v))


class PreintState(NamedTuple):
    """Preintegrated measurement between two stamps (at a bias lin point);
    fields may carry a leading batch axis."""

    dR: torch.Tensor       # [3, 3]
    dv: torch.Tensor       # [3]
    dp: torch.Tensor       # [3]
    dt: torch.Tensor       # scalar total time
    dR_dbg: torch.Tensor   # [3, 3]
    dv_dbg: torch.Tensor   # [3, 3]
    dv_dba: torch.Tensor   # [3, 3]
    dp_dbg: torch.Tensor   # [3, 3]
    dp_dba: torch.Tensor   # [3, 3]
    cov: torch.Tensor      # [9, 9] on [r_R, r_v, r_p]
    bias_lin: torch.Tensor  # [6] bias linearization point [bg, ba]


def state_from_np(pre_np: dict, device) -> PreintState:
    """Device f32 PreintState from a host preintegration dict (the f64 host
    result cast to f32; `pre_np` fields may carry a leading batch axis)."""
    return PreintState(*(
        torch.as_tensor(np.asarray(pre_np[f], np.float32), device=device)
        for f in PreintState._fields))


def identity_preint(bias: torch.Tensor) -> PreintState:
    dev = bias.device
    I = torch.eye(3, device=dev)
    Z = torch.zeros(3, 3, device=dev)
    return PreintState(
        dR=I, dv=torch.zeros(3, device=dev), dp=torch.zeros(3, device=dev),
        dt=torch.zeros((), device=dev), dR_dbg=Z, dv_dbg=Z, dv_dba=Z,
        dp_dbg=Z, dp_dba=Z, cov=torch.zeros(9, 9, device=dev),
        bias_lin=bias.to(torch.float32))


def _right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO3 right Jacobian Jr(w) (Jr = Jl(-w))."""
    t2 = torch.sum(w * w)
    t = torch.sqrt(torch.clamp(t2, min=0.0))
    small = t2 < 1e-8
    one = torch.ones_like(t2)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.where(small, one, t2))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / torch.where(small, one, t2 * t))
    W = lie.hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) - b * W \
        + c * (W @ W)


def _block(rows):
    return torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)


def preintegrate(acc: torch.Tensor, gyr: torch.Tensor, dts: torch.Tensor,
                 bias: torch.Tensor, sigma_gyro: float = None,
                 sigma_acc: float = None,
                 sigma_integration: float = None) -> PreintState:
    """Integrate all measurements ([N, 3], [N, 3], [N]; dt = 0 rows are
    padding) into one PreintState at the bias linearization point [6]."""
    sigma_gyro = NOISE.sigma_gyro if sigma_gyro is None else sigma_gyro
    sigma_acc = NOISE.sigma_acc if sigma_acc is None else sigma_acc
    sigma_integration = (NOISE.sigma_integration
                         if sigma_integration is None else sigma_integration)
    dev = acc.device
    bg = bias[:3]
    ba = bias[3:6]
    I = torch.eye(3, device=dev)
    Z = torch.zeros(3, 3, device=dev)
    cov_w = (sigma_gyro ** 2) * I
    cov_a = (sigma_acc ** 2) * I
    cov_i = (sigma_integration ** 2) * I
    st = identity_preint(bias)
    for a, w, dt in zip(acc, gyr, dts):
        valid = dt > 0
        dts_ = torch.where(valid, dt, torch.zeros_like(dt))
        a_c = a - ba
        w_c = (w - bg) * dts_
        dRk = lie.so3_exp(w_c)
        Jr = _right_jacobian(w_c)
        aH = lie.hat(a_c)

        dR_new = st.dR @ dRk
        dv_new = st.dv + st.dR @ a_c * dts_
        dp_new = st.dp + st.dv * dts_ + 0.5 * st.dR @ a_c * dts_ ** 2
        dR_dbg_new = dRk.T @ st.dR_dbg - Jr * dts_
        dv_dbg_new = st.dv_dbg - st.dR @ aH @ st.dR_dbg * dts_
        dv_dba_new = st.dv_dba - st.dR * dts_
        dp_dbg_new = st.dp_dbg + st.dv_dbg * dts_ \
            - 0.5 * st.dR @ aH @ st.dR_dbg * dts_ ** 2
        dp_dba_new = st.dp_dba + st.dv_dba * dts_ - 0.5 * st.dR * dts_ ** 2

        # Covariance propagation: x = [dtheta, dv, dp].
        A = _block([[dRk.T, Z, Z],
                    [-st.dR @ aH * dts_, I, Z],
                    [-0.5 * st.dR @ aH * dts_ ** 2, I * dts_, I]])
        B = _block([[Jr * dts_, Z, Z],
                    [Z, st.dR * dts_, Z],
                    [Z, 0.5 * st.dR * dts_ ** 2, st.dR * dts_]])
        dt_safe = torch.where(valid, dts_, torch.ones_like(dts_))
        Q = _block([[cov_w / dt_safe, Z, Z],
                    [Z, cov_a / dt_safe, Z],
                    [Z, Z, cov_i * dt_safe]])
        cov_new = A @ st.cov @ A.T + B @ Q @ B.T

        def sel(n, o):
            return torch.where(valid, n, o)
        st = PreintState(
            dR=sel(dR_new, st.dR), dv=sel(dv_new, st.dv),
            dp=sel(dp_new, st.dp), dt=st.dt + dts_,
            dR_dbg=sel(dR_dbg_new, st.dR_dbg),
            dv_dbg=sel(dv_dbg_new, st.dv_dbg),
            dv_dba=sel(dv_dba_new, st.dv_dba),
            dp_dbg=sel(dp_dbg_new, st.dp_dbg),
            dp_dba=sel(dp_dba_new, st.dp_dba),
            cov=sel(cov_new, st.cov), bias_lin=st.bias_lin)
    return st


def imu_residual(pre: PreintState, R_i, p_i, v_i, R_j, p_j, v_j,
                 bias_i: torch.Tensor,
                 gravity_mag: float = GRAVITY) -> torch.Tensor:
    """9-dim preintegration residual [r_R, r_v, r_p] (unweighted) between
    metric-world body states, with the first-order bias correction
    (gtsam::ImuFactor semantics). Broadcasts over leading batch axes."""
    dbg = bias_i[..., :3] - pre.bias_lin[..., :3]
    dba = bias_i[..., 3:6] - pre.bias_lin[..., 3:6]
    g = torch.tensor([0.0, 0.0, -gravity_mag], dtype=R_i.dtype,
                     device=R_i.device)
    dt = pre.dt[..., None]

    dR_corr = pre.dR @ lie.so3_exp(lie._mv(pre.dR_dbg, dbg))
    dv_corr = pre.dv + lie._mv(pre.dv_dbg, dbg) + lie._mv(pre.dv_dba, dba)
    dp_corr = pre.dp + lie._mv(pre.dp_dbg, dbg) + lie._mv(pre.dp_dba, dba)

    R_iT = R_i.transpose(-1, -2)
    r_R = lie.so3_log(dR_corr.transpose(-1, -2) @ R_iT @ R_j)
    r_v = lie._mv(R_iT, v_j - v_i - g * dt) - dv_corr
    r_p = lie._mv(R_iT, p_j - p_i - v_i * dt - 0.5 * g * dt ** 2) - dp_corr
    return torch.cat([r_R, r_v, r_p], dim=-1)


def sqrt_information(pre: PreintState, jitter: float = 1e-10):
    """Sqrt information W with W^T W = cov^{-1} (W = L^{-1}, cov = L L^T)."""
    cov = pre.cov + jitter * torch.eye(9, dtype=pre.cov.dtype,
                                       device=pre.cov.device)
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    return torch.linalg.inv(torch.linalg.cholesky(cov))


def bias_walk_sqrt_info(dt: torch.Tensor, sigma_gyro_walk: float = None,
                        sigma_acc_walk: float = None) -> torch.Tensor:
    """Sqrt information [..., 6, 6] of the bias random-walk between-factor
    (computeBiasNoiseModel, IMUUtils.h:40) over dt [...]."""
    sigma_gyro_walk = (NOISE.sigma_gyro_walk
                       if sigma_gyro_walk is None else sigma_gyro_walk)
    sigma_acc_walk = (NOISE.sigma_acc_walk
                      if sigma_acc_walk is None else sigma_acc_walk)
    dt_safe = torch.clamp(dt, min=1e-6)[..., None]
    sg = 1.0 / (sigma_gyro_walk * torch.sqrt(dt_safe))
    sa = 1.0 / (sigma_acc_walk * torch.sqrt(dt_safe))
    ones = torch.ones(3, dtype=dt.dtype, device=dt.device)
    return torch.diag_embed(torch.cat([sg * ones, sa * ones], dim=-1))


# ---------------------------------------------------------------------------
# Host float64 preintegration (copied from the reference, NumPy only).
# ---------------------------------------------------------------------------


def _hat_np_b(w):
    """[N,3] -> [N,3,3] (host float64)."""
    N = w.shape[0]
    W = np.zeros((N, 3, 3), np.float64)
    W[:, 0, 1] = -w[:, 2]
    W[:, 0, 2] = w[:, 1]
    W[:, 1, 0] = w[:, 2]
    W[:, 1, 2] = -w[:, 0]
    W[:, 2, 0] = -w[:, 1]
    W[:, 2, 1] = w[:, 0]
    return W


def _exp_so3_np_b(w):
    """Batched exp map matching the scalar branch structure of
    preintegrate_np_ref (small-angle: I + W + 0.5 W^2)."""
    t = np.linalg.norm(w, axis=-1)
    W = _hat_np_b(w)
    W2 = W @ W
    small = t < 1e-8
    ts = np.where(small, 1.0, t)
    c1 = np.where(small, 1.0, np.sin(ts) / ts)
    c2 = np.where(small, 0.5, (1 - np.cos(ts)) / (ts * ts))
    return np.eye(3) + c1[:, None, None] * W + c2[:, None, None] * W2


def _right_jac_np_b(w):
    t = np.linalg.norm(w, axis=-1)
    W = _hat_np_b(w)
    W2 = W @ W
    small = t < 1e-6
    ts = np.where(small, 1.0, t)
    c1 = np.where(small, 0.5, (1 - np.cos(ts)) / (ts * ts))
    c2 = np.where(small, 1.0 / 6.0, (ts - np.sin(ts)) / (ts ** 3))
    return np.eye(3) - c1[:, None, None] * W + c2[:, None, None] * W2


def preintegrate_np(acc, gyr, dts, bias):
    """Host-side float64 preintegration (NumPy), vectorized: the per-sample
    SO(3) terms are batched, the bias Jacobians use closed forms of the
    reference recursion, and only the dR prefix chain and the 9x9
    covariance recursion stay sequential. Returns a dict with the fields
    of PreintState (numpy float64); agrees with preintegrate_np_ref to
    float64 roundoff."""
    bg = np.asarray(bias[:3], np.float64)
    ba = np.asarray(bias[3:6], np.float64)
    sg, sa, si = NOISE.sigma_gyro, NOISE.sigma_acc, NOISE.sigma_integration

    dts_all = np.asarray(dts, np.float64)
    keep = dts_all > 0
    dt = dts_all[keep]
    N = int(dt.shape[0])
    out_zero = {
        "dR": np.eye(3), "dv": np.zeros(3), "dp": np.zeros(3), "dt": 0.0,
        "cov": np.zeros((9, 9)),
        "dR_dbg": np.zeros((3, 3)), "dv_dbg": np.zeros((3, 3)),
        "dv_dba": np.zeros((3, 3)), "dp_dbg": np.zeros((3, 3)),
        "dp_dba": np.zeros((3, 3)),
        "bias_lin": np.concatenate([bg, ba]),
    }
    if N == 0:
        return out_zero
    a_c = np.asarray(acc, np.float64)[keep] - ba              # [N,3]
    w_c = (np.asarray(gyr, np.float64)[keep] - bg) * dt[:, None]

    dRk = _exp_so3_np_b(w_c)          # [N,3,3]
    Jr = _right_jac_np_b(w_c)
    aH = _hat_np_b(a_c)

    # dR prefix chain: P[k] = product of the first k sample rotations.
    P = np.empty((N + 1, 3, 3))
    P[0] = np.eye(3)
    for k in range(N):
        np.matmul(P[k], dRk[k], out=P[k + 1])
    dR_prev = P[:N]                   # rotation BEFORE step k
    dR_incl = P[1:]                   # rotation INCLUDING step k
    dR = P[N]

    dtc = dt[:, None]
    dRa = (dR_prev @ a_c[..., None])[..., 0] * dtc            # [N,3]
    M = dR_prev @ aH * dt[:, None, None]                      # dR aH dt

    # States (cumulative sums in loop order).
    dv_pfx = np.cumsum(dRa, axis=0)
    dv_prev = np.vstack([np.zeros(3), dv_pfx[:-1]])
    dv = dv_pfx[-1]
    dp = (dv_prev * dtc + 0.5 * dtc * dRa).sum(axis=0)

    # Gyro-bias Jacobians via prefix identities.
    T_terms = dR_incl @ Jr * dt[:, None, None]                # [N,3,3]
    S = np.cumsum(T_terms, axis=0)                            # S_k
    dR_dbg = -dR.T @ S[-1]
    U = np.zeros((N, 3, 3))
    if N > 1:
        U[1:] = M[1:] @ np.swapaxes(dR_incl[:-1], -1, -2) @ S[:-1]
    dv_dbg_pfx = np.cumsum(U, axis=0)
    dv_dbg_prev = np.concatenate([np.zeros((1, 3, 3)), dv_dbg_pfx[:-1]])
    dv_dbg = dv_dbg_pfx[-1]
    dp_dbg = (dv_dbg_prev * dt[:, None, None]
              + 0.5 * dt[:, None, None] * U).sum(axis=0)

    # Accel-bias Jacobians (pure cumulative sums).
    dv_dba_steps = -dR_prev * dtc[..., None]
    dv_dba_pfx = np.cumsum(dv_dba_steps, axis=0)
    dv_dba_prev = np.concatenate([np.zeros((1, 3, 3)), dv_dba_pfx[:-1]])
    dv_dba = dv_dba_pfx[-1]
    dp_dba = (dv_dba_prev * dt[:, None, None]
              - 0.5 * dR_prev * (dt * dt)[:, None, None]).sum(axis=0)

    # Covariance: batch-assemble A_k and B_k Q_k B_k^T, then the (small)
    # sequential 9x9 recursion.
    A = np.zeros((N, 9, 9))
    A[:, 0:3, 0:3] = np.swapaxes(dRk, -1, -2)
    A[:, 3:6, 0:3] = -M
    A[:, 3:6, 3:6] = np.eye(3)
    A[:, 6:9, 0:3] = -0.5 * M * dt[:, None, None]
    A[:, 6:9, 3:6] = np.eye(3) * dtc[..., None]
    A[:, 6:9, 6:9] = np.eye(3)
    B = np.zeros((N, 9, 9))
    B[:, 0:3, 0:3] = Jr * dt[:, None, None]
    B[:, 3:6, 3:6] = dR_prev * dt[:, None, None]
    B[:, 6:9, 3:6] = 0.5 * dR_prev * (dt * dt)[:, None, None]
    B[:, 6:9, 6:9] = dR_prev * dt[:, None, None]
    q = np.zeros((N, 9))
    q[:, 0:3] = (sg ** 2 / dt)[:, None]
    q[:, 3:6] = (sa ** 2 / dt)[:, None]
    q[:, 6:9] = (si ** 2 * dt)[:, None]
    C = (B * q[:, None, :]) @ np.swapaxes(B, -1, -2)
    cov = np.zeros((9, 9))
    for k in range(N):
        cov = A[k] @ cov @ A[k].T + C[k]

    return {
        "dR": dR, "dv": dv, "dp": dp, "dt": float(dt.sum()), "cov": cov,
        "dR_dbg": dR_dbg, "dv_dbg": dv_dbg, "dv_dba": dv_dba,
        "dp_dbg": dp_dbg, "dp_dba": dp_dba,
        "bias_lin": np.concatenate([bg, ba]),
    }


def preintegrate_np_ref(acc, gyr, dts, bias):
    """Per-step loop form of preintegrate_np (ground truth for the
    vectorized path)."""
    bg = np.asarray(bias[:3], np.float64)
    ba = np.asarray(bias[3:6], np.float64)
    sg, sa, si = NOISE.sigma_gyro, NOISE.sigma_acc, NOISE.sigma_integration
    dR = np.eye(3)
    dv = np.zeros(3)
    dp = np.zeros(3)
    T = 0.0
    dR_dbg = np.zeros((3, 3))
    dv_dbg = np.zeros((3, 3))
    dv_dba = np.zeros((3, 3))
    dp_dbg = np.zeros((3, 3))
    dp_dba = np.zeros((3, 3))
    cov = np.zeros((9, 9))

    def hat(w):
        return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                         [-w[1], w[0], 0]])

    def exp_so3(w):
        t = np.linalg.norm(w)
        W = hat(w)
        if t < 1e-8:
            return np.eye(3) + W + 0.5 * W @ W
        return (np.eye(3) + np.sin(t) / t * W
                + (1 - np.cos(t)) / (t * t) * W @ W)

    def right_jac(w):
        t = np.linalg.norm(w)
        W = hat(w)
        if t < 1e-6:
            return np.eye(3) - 0.5 * W + W @ W / 6.0
        return (np.eye(3) - (1 - np.cos(t)) / (t * t) * W
                + (t - np.sin(t)) / (t ** 3) * W @ W)

    I3 = np.eye(3)
    Z3 = np.zeros((3, 3))
    for k in range(len(dts)):
        dt = float(dts[k])
        if dt <= 0:
            continue
        a_c = np.asarray(acc[k], np.float64) - ba
        w_c = (np.asarray(gyr[k], np.float64) - bg) * dt
        dRk = exp_so3(w_c)
        Jr = right_jac(w_c)
        aH = hat(a_c)

        A = np.block([
            [dRk.T, Z3, Z3],
            [-dR @ aH * dt, I3, Z3],
            [-0.5 * dR @ aH * dt * dt, I3 * dt, I3],
        ])
        B = np.block([
            [Jr * dt, Z3, Z3],
            [Z3, dR * dt, Z3],
            [Z3, 0.5 * dR * dt * dt, dR * dt],
        ])
        Q = np.block([
            [sg ** 2 / dt * I3, Z3, Z3],
            [Z3, sa ** 2 / dt * I3, Z3],
            [Z3, Z3, si ** 2 * dt * I3],
        ])
        cov = A @ cov @ A.T + B @ Q @ B.T

        dR_dbg_n = dRk.T @ dR_dbg - Jr * dt
        dv_dbg_n = dv_dbg - dR @ aH @ dR_dbg * dt
        dv_dba_n = dv_dba - dR * dt
        dp_dbg_n = dp_dbg + dv_dbg * dt - 0.5 * dR @ aH @ dR_dbg * dt * dt
        dp_dba_n = dp_dba + dv_dba * dt - 0.5 * dR * dt * dt
        dp = dp + dv * dt + 0.5 * dR @ a_c * dt * dt
        dv = dv + dR @ a_c * dt
        dR = dR @ dRk
        dR_dbg, dv_dbg, dv_dba = dR_dbg_n, dv_dbg_n, dv_dba_n
        dp_dbg, dp_dba = dp_dbg_n, dp_dba_n
        T += dt
    return {
        "dR": dR, "dv": dv, "dp": dp, "dt": T, "cov": cov,
        "dR_dbg": dR_dbg, "dv_dbg": dv_dbg, "dv_dba": dv_dba,
        "dp_dbg": dp_dbg, "dp_dba": dp_dba,
        "bias_lin": np.concatenate([bg, ba]),
    }
