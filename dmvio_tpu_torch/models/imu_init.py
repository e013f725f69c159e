"""IMU initialization: gravity bootstrap + coarse IMU init optimizer.

Counterpart of dmvio_tpu/models/imu_init.py (GravityInitializer +
CoarseIMUInitOptimizer): LM over ONLY the IMU variables - per-pose
velocities, one shared bias, scale, gravity - with the camera poses fixed
from visual tracking, over a window of up to N_MAX poses, on the dense
state

    x = [s_log, g2(2), bias(6), v_0..v_{N-1} (3N)].

The reference differentiates the stacked residual with jax.jacfwd over all
of x; pair q depends only on (s_log, g2, bias, v_q, v_{q+1}), so here
forward mode runs over those 15 local coordinates for all pairs at once
(vio_ba.local_jacobian) and the blocks are placed into the dense Jacobian:
the same derivatives. The reference's `while_loop` is a Python loop with
the same early exit. The reference's optional per-pose tracker-sigma
weighting (off by default there, behind DMVIO_INIT_SIGMAS=1) is not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvio_tpu_torch.models.vio_ba import dso_to_body, local_jacobian
from dmvio_tpu_torch.ops import preint
from dmvio_tpu_torch.utils import lie

N_MAX = 100   # reference init_coarseInitSettings maxNumPoses

# Visual pose-noise floor folded into the measurement covariance: without
# it the MAP answer is to shrink the world so the noisy tracked positions
# stop mattering.
SIG_VIS_ROT = 2e-3    # rad
SIG_VIS_VEL = 0.02    # m/s
SIG_VIS_POS = 0.005   # m


def gravity_from_accel(acc_mean: torch.Tensor) -> torch.Tensor:
    """First gravity-direction guess from the mean accelerometer vector in
    the DSO camera frame: the g2 tangent such that R_g = exp([g2, 0]) maps
    the metric world's -z gravity to the measured "up" direction."""
    up = acc_mean / torch.clamp(torch.linalg.norm(acc_mean), min=1e-9)
    mz = torch.tensor([0.0, 0.0, 1.0], dtype=up.dtype, device=up.device)
    axis = torch.linalg.cross(mz, up)
    s = torch.linalg.norm(axis)
    c = up @ mz
    ang = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=1e-9)
    return (axis * ang)[:2]


class CoarseInitState(NamedTuple):
    """Fixed-capacity pose buffer for the coarse IMU initializer."""

    R_cw: torch.Tensor    # [N, 3, 3] DSO worldToCam poses (fixed)
    t_cw: torch.Tensor    # [N, 3]
    pre: preint.PreintState   # batched [N-1] chunks pose k -> k+1
    valid: torch.Tensor   # [N] pose slots in use (contiguous prefix)


class CoarseInitResult(NamedTuple):
    s_log: torch.Tensor
    g2: torch.Tensor
    bias: torch.Tensor     # [6] shared
    v: torch.Tensor        # [N, 3]
    energy: torch.Tensor
    s_var: torch.Tensor    # marginal variance of s_log (init-quality gate)
    ok: torch.Tensor


def _pair_residual(pre, R_i, t_i, R_j, t_j, ok, y, R_cb, t_cb):
    """Weighted 9-dim residuals [Q, 9] of the pose pairs as a function of
    their local coordinates y [Q, 15] = [s_log, g2(2), bias(6), v_q(3),
    v_q+1(3)]; pairs with `ok` False give zeros."""
    s_log, g2, bias = y[:, 0], y[:, 1:3], y[:, 3:9]
    Rb_i, pb_i = dso_to_body(R_i, t_i, s_log, g2, R_cb, t_cb)
    Rb_j, pb_j = dso_to_body(R_j, t_j, s_log, g2, R_cb, t_cb)
    r9 = preint.imu_residual(pre, Rb_i, pb_i, y[:, 9:12], Rb_j, pb_j,
                             y[:, 12:15], bias)
    ones = torch.ones(3, dtype=y.dtype, device=y.device)
    infl = torch.diag(torch.cat([ones * SIG_VIS_ROT ** 2,
                                 ones * SIG_VIS_VEL ** 2,
                                 ones * SIG_VIS_POS ** 2]))
    cov = pre.cov + infl
    L = torch.linalg.cholesky(
        0.5 * (cov + cov.transpose(-1, -2))
        + 1e-12 * torch.eye(9, dtype=y.dtype, device=y.device))
    r = lie._mv(torch.linalg.inv(L), r9)
    return torch.where(ok[:, None], r, torch.zeros_like(r))


def _local(x, N: int):
    """[N-1, 15] local coordinates of every pair from the dense state."""
    v = x[9:].reshape(N, 3)
    glob = x[:9].expand(N - 1, 9)
    return torch.cat([glob, v[:-1], v[1:]], dim=1)


def _linearize(x, st: CoarseInitState, R_cb, t_cb, with_jacobian: bool):
    """(r [9(N-1)], J [9(N-1), 9 + 3N] or None) at the dense state x."""
    N = st.R_cw.shape[0]
    ok = st.valid[:-1] & st.valid[1:]

    def res(y):
        return _pair_residual(st.pre, st.R_cw[:-1], st.t_cw[:-1],
                              st.R_cw[1:], st.t_cw[1:], ok, y, R_cb, t_cb)

    y = _local(x, N)
    r = res(y).reshape(-1)
    if not with_jacobian:
        return r, None
    Jl = local_jacobian(res, y)                           # [N-1, 9, 15]
    Q = N - 1
    J = torch.zeros(Q, 9, 9 + 3 * N, dtype=x.dtype, device=x.device)
    J[:, :, :9] = Jl[..., :9]
    q = torch.arange(Q, device=x.device)
    cols = 9 + 3 * q[:, None] + torch.arange(6, device=x.device)  # [Q, 6]
    J[q[:, None, None], torch.arange(9, device=x.device)[None, :, None],
      cols[:, None, :]] = Jl[..., 9:]
    return r, J.reshape(Q * 9, -1)


def optimize(st: CoarseInitState, R_cb, t_cb, s_log0, g20, bias0, v0,
             iters: int = 12,
             bias_prior: float = 1.0 / (0.1 ** 2)) -> CoarseInitResult:
    """LM over [s, g2, bias, velocities] with the poses fixed; the scale
    marginal variance gates the handoff (IMUInitializerTransitions)."""
    N = st.R_cw.shape[0]
    dim = 9 + 3 * N
    dev = st.R_cw.device

    x0 = torch.cat([s_log0.reshape(1), g20, bias0, v0.reshape(-1)])
    prior_diag = torch.zeros(dim, device=dev)
    prior_diag[3:9] = bias_prior

    def energy(x):
        r, _ = _linearize(x, st, R_cb, t_cb, False)
        return torch.sum(r * r) + torch.sum(prior_diag * (x - x0) ** 2)

    # Mask velocity coords of unused slots.
    vmask = torch.cat([torch.ones(9, dtype=torch.bool, device=dev),
                       torch.repeat_interleave(st.valid, 3)]) \
        .to(torch.float32)
    eye = torch.eye(dim, device=dev)
    x, e = x0, energy(x0)
    lam = torch.tensor(1e-3, device=dev)
    for _ in range(iters):
        r, J = _linearize(x, st, R_cb, t_cb, True)
        H = J.T @ J + torch.diag(prior_diag)
        b = J.T @ r + prior_diag * (x - x0)
        H = H * vmask[:, None] * vmask[None, :] + torch.diag(1.0 - vmask)
        b = b * vmask
        Hl = H + lam * torch.diag(torch.diagonal(H))
        # Jacobi equilibration: sqrt-info weights reach ~1e5, so H spans
        # ~1e10 and a raw f32 solve collapses.
        d = torch.sqrt(torch.clamp(torch.diagonal(Hl), min=1e-12))
        Hp = Hl / (d[:, None] * d[None, :]) + 1e-7 * eye
        dx = torch.linalg.solve_ex(Hp, -(b / d))[0] / d
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)) \
            * vmask
        xn = x + dx
        # Keep scale/gravity in a sane region (divergence guard).
        xn = torch.cat([torch.clamp(xn[:1], -6.0, 6.0),
                        torch.clamp(xn[1:3], -1.5, 1.5), xn[3:]])
        en = energy(xn)
        acc = (en < e) & torch.isfinite(en)
        done = (torch.sum(dx * dx) < 1e-14) | (lam > 1e6)
        x = torch.where(acc, xn, x)
        e = torch.where(acc, en, e)
        lam = torch.where(acc, torch.clamp(lam * 0.25, min=1e-8), lam * 4.0)
        if bool(done):          # the one host read per LM iteration
            break

    # Scale marginal variance from the final (equilibrated) Hessian.
    _, J = _linearize(x, st, R_cb, t_cb, True)
    H = J.T @ J + torch.diag(prior_diag)
    H = H * vmask[:, None] * vmask[None, :] + torch.diag(1.0 - vmask)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hp = H / (d[:, None] * d[None, :]) + 1e-7 * eye
    e0 = torch.zeros(dim, device=dev)
    e0[0] = 1.0
    s_var = (torch.linalg.solve_ex(Hp, e0 / d)[0] / d)[0]

    n_valid = torch.sum(st.valid.to(torch.float32))
    ok = torch.isfinite(e) & (n_valid >= 3)
    return CoarseInitResult(s_log=x[0], g2=x[1:3], bias=x[3:9],
                            v=x[9:].reshape(N, 3), energy=e, s_var=s_var,
                            ok=ok)
