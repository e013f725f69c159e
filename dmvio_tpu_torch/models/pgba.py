# Copy of dmvio_tpu/models/pgba.py (NumPy only): the port keeps its own
# copy so that it imports nothing of the JAX package.
"""Pose Graph Bundle Adjustment over the delayed window.

TPU-native re-design of PoseGraphBundleAdjustment
(src/IMUInitialization/PoseGraphBundleAdjustment.{h,cpp}): clone the
delayed log, inject relinearizable IMU factors + the active visual Hessian
factor, and LM-optimize scale, gravity, velocities, biases AND POSES
jointly over the whole delayed history (optimize :59-100, buildGraph
:210-283, insertIMUFactorsAndValues :284). Freeing the poses is what makes
scale strongly observable — the coarse init and the sliding window both
treat poses as (noisy) constants and inherit their gauge drift.

Implementation: host float64 LM over stacked state arrays. The problem is
small (tens of keyframes, C = 3 + 17K <= ~1700) but runs concurrently with
the realtime pipeline (background thread, RealtimePGBAState parity), so
the host cost matters twice: total time AND GIL-held time. All per-pair
work is batched (imu_factors.linearize_pairs_batch) and the pair weights /
scatter indices are computed once per run — the remaining heavy ops are
LAPACK solves that release the GIL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from dmvio_tpu_torch.models import imu_factors
from dmvio_tpu_torch.models.delayed import (DelayedLog, GDIM, KDIM,
                                            KFState, MargEvent, _state_delta,
                                            pair_weights_batch)


def _psd_solve(A, b):
    """Cholesky solve (A consumed/overwritten); None when not PD."""
    try:
        import scipy.linalg as sla

        c, low = sla.cho_factor(A, lower=True, overwrite_a=True,
                                check_finite=False)
        return sla.cho_solve((c, low), b, check_finite=False)
    except Exception:
        try:
            return np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            return None


@dataclasses.dataclass
class PGBAResult:
    ok: bool
    s_log: float
    g2: np.ndarray
    states: Dict[int, KFState]
    s_var: float
    energy: float
    n_kfs: int


def _assemble_quadratics(log: DelayedLog, extra_events: List[MargEvent],
                         fids: List[int], fej: Dict[int, KFState],
                         s_log0: float, g20: np.ndarray):
    """Scatter tail + events into one (H, b0) over the PGBA layout, with b
    transported to the common `fej`."""
    off = {f: GDIM + k * KDIM for k, f in enumerate(fids)}
    C = GDIM + len(fids) * KDIM
    H = np.zeros((C, C))
    b = np.zeros(C)

    def scatter(Hs, bs, src_fids, src_fej, src_s0, src_g20):
        keep = [f for f in src_fids if f in off]
        if len(keep) != len(src_fids):
            return  # references a fid outside the PGBA window; skip
        src_off = {f: GDIM + k * KDIM for k, f in enumerate(src_fids)}
        idx = np.concatenate(
            [np.arange(GDIM)] + [off[f] + np.arange(KDIM) for f in src_fids])
        sidx = np.concatenate(
            [np.arange(GDIM)] +
            [src_off[f] + np.arange(KDIM) for f in src_fids])
        Hsub = Hs[np.ix_(sidx, sidx)]
        delta = np.zeros(len(sidx))
        delta[0] = s_log0 - src_s0
        delta[1:3] = np.asarray(g20) - np.asarray(src_g20)
        for k, f in enumerate(src_fids):
            if f in fej and f in src_fej:
                delta[GDIM + k * KDIM: GDIM + (k + 1) * KDIM] = \
                    _state_delta(fej[f], src_fej[f])
        H[np.ix_(idx, idx)] += Hsub
        b[idx] += bs[sidx] + Hsub @ delta

    if log.tail_H is not None:
        scatter(log.tail_H, log.tail_b0, log.tail_fids, log.tail_fej,
                log.tail_s0, log.tail_g20)
    for ev in list(log.events) + extra_events:
        scatter(ev.H, ev.b0, ev.fids, ev.fej, ev.s_log0, ev.g20)
    return H, b, off


class _Stacked:
    """States of the PGBA keyframe set as stacked [K, ...] float64 arrays."""

    __slots__ = ("R", "t", "aff", "v", "bg", "ba")

    def __init__(self, states: Dict[int, KFState], fids: List[int]):
        self.R = np.stack([np.asarray(states[f].R_cw, np.float64)
                           for f in fids])
        self.t = np.stack([np.asarray(states[f].t_cw, np.float64)
                           for f in fids])
        self.aff = np.stack([np.asarray(states[f].aff, np.float64)
                             for f in fids])
        self.v = np.stack([np.asarray(states[f].v, np.float64)
                           for f in fids])
        self.bg = np.stack([np.asarray(states[f].bg, np.float64)
                            for f in fids])
        self.ba = np.stack([np.asarray(states[f].ba, np.float64)
                            for f in fids])

    def copy(self) -> "_Stacked":
        out = object.__new__(_Stacked)
        for f in self.__slots__:
            setattr(out, f, getattr(self, f).copy())
        return out


def _delta_states(cur: _Stacked, ref: _Stacked) -> np.ndarray:
    """Batched _state_delta: [K, 17] delta = cur (-) ref."""
    dR = cur.R @ np.swapaxes(ref.R, -1, -2)
    w = imu_factors._log_so3_b(dR)
    V = imu_factors._jl_so3_b(w)
    dt = cur.t - (dR @ ref.t[..., None])[..., 0]
    vpart = np.linalg.solve(V, dt[..., None])[..., 0]
    return np.concatenate([vpart, w, cur.aff - ref.aff, cur.v - ref.v,
                           cur.bg - ref.bg, cur.ba - ref.ba], axis=-1)


def run(log: DelayedLog,
        window_states: Dict[int, KFState],
        active_event: Optional[MargEvent],
        s_log0: float, g20: np.ndarray,
        iters: int = 12,
        max_kfs: int = 100) -> Optional[PGBAResult]:
    """LM over [s, g2, per-KF (xi, aff, v, bg, ba)].

    window_states: current-window keyframe states (their visual info enters
    via `active_event`, the active DSO Hessian factor — getActiveDSOFactor
    parity, BAGTSAMIntegration.cpp:473-481).
    """
    fids = log.delayed_fids()
    for f in window_states:
        if f not in fids:
            fids.append(f)
    fids = sorted(fids)[-max_kfs:]
    if len(fids) < 6:
        return None

    # Initial states: window (current) where available, else event FEJ.
    fej: Dict[int, KFState] = {}
    for ev in list(log.events):
        for f, st in ev.fej.items():
            if f in fids:
                fej.setdefault(f, st)
    for f, st in log.tail_fej.items():
        if f in fids:
            fej.setdefault(f, st)
    for f, st in window_states.items():
        if f in fids:
            fej[f] = st
    if any(f not in fej for f in fids):
        return None

    H_quad, b_quad0, off = _assemble_quadratics(
        log, [active_event] if active_event is not None else [],
        fids, fej, s_log0, g20)
    C = GDIM + len(fids) * KDIM
    # Gauge anchor: pin the oldest keyframe's pose + affine.
    o0 = off[fids[0]]
    anchor = np.zeros(C)
    anchor[o0:o0 + 8] = 1e8
    H_quad[np.arange(C), np.arange(C)] += anchor

    pairs = [p for p in log.pairs
             if p.fid_i in off and p.fid_j in off]
    if len(pairs) < 4:
        return None

    # Batched pair machinery, built ONCE (preints and weights are constant
    # across LM iterations; only the states move).
    fid_pos = {f: k for k, f in enumerate(fids)}
    pres = [p.pre for p in pairs]
    W9, Wb = pair_weights_batch(pres)
    batch = imu_factors.PairBatch(
        pres, [fid_pos[p.fid_i] for p in pairs],
        [fid_pos[p.fid_j] for p in pairs], W9, Wb)
    blk = np.concatenate([np.arange(6), 8 + np.arange(9)])
    pair_idx = np.stack([
        np.concatenate([np.arange(GDIM), off[p.fid_i] + blk,
                        off[p.fid_j] + blk]) for p in pairs])  # [N,33]

    R_cb, t_cb = log.R_cb, log.t_cb

    def weighted(r, J):
        rw = np.concatenate([(W9 @ r[:, :9, None])[..., 0],
                             (Wb @ r[:, 9:, None])[..., 0]], axis=1)
        if J is None:
            return rw, None
        Jw = np.concatenate([W9 @ J[:, :9], Wb @ J[:, 9:]], axis=1)
        return rw, Jw

    def pair_system(st: _Stacked, sl: float, gg: np.ndarray):
        r, J = imu_factors.linearize_pairs_batch(
            batch, st.R, st.t, st.v, st.bg, st.ba, sl, gg, R_cb, t_cb)
        rw, Jw = weighted(r, J)
        JwT = np.swapaxes(Jw, 1, 2)
        Hp = JwT @ Jw                                   # [N,33,33]
        bp = (JwT @ rw[..., None])[..., 0]              # [N,33]
        H = np.zeros((C, C))
        b = np.zeros(C)
        np.add.at(H, (pair_idx[:, :, None], pair_idx[:, None, :]), Hp)
        np.add.at(b, pair_idx, bp)
        return H, b

    def pair_energy(st: _Stacked, sl: float, gg: np.ndarray) -> float:
        r, _ = imu_factors.linearize_pairs_batch(
            batch, st.R, st.t, st.v, st.bg, st.ba, sl, gg, R_cb, t_cb,
            want_jac=False)
        rw, _ = weighted(r, None)
        return float(np.sum(rw * rw))

    def quad_energy(d):
        return float(d @ (H_quad @ d) + 2.0 * b_quad0 @ d)

    # LM state: deltas relative to `fej` (poses retracted on accept).
    fej_s = _Stacked(fej, fids)
    cur = fej_s.copy()
    s_log = float(s_log0)
    g2 = np.asarray(g20, np.float64).copy()
    lam = 1e-4

    def delta_vec(st: _Stacked, sl: float, gg: np.ndarray):
        d = np.zeros(C)
        d[0] = sl - s_log0
        d[1:3] = gg - g20
        d[GDIM:] = _delta_states(st, fej_s).reshape(-1)
        return d

    e_cur = pair_energy(cur, s_log, g2) + quad_energy(
        delta_vec(cur, s_log, g2))

    for it in range(iters):
        Hp, bp = pair_system(cur, s_log, g2)
        d = delta_vec(cur, s_log, g2)
        H = Hp + H_quad
        b = bp + b_quad0 + H_quad @ d
        # Damped normal equations, solved by Cholesky (the system is PSD +
        # damping; dpotrf is ~3x cheaper than the generic LU and releases
        # the GIL for its whole duration — this solve is the PGBA cycle's
        # dominant cost at delay 100, C ~ 1700).
        Hl = H.copy()
        dg = np.einsum("ii->i", Hl)
        dg *= (1.0 + lam)
        dg += 1e-9
        dx = _psd_solve(Hl, -b)
        if dx is None:
            return None
        # Propose (batched left-increment retraction).
        s_n = float(np.clip(s_log + dx[0], s_log0 - 3, s_log0 + 3))
        g_n = g2 + dx[1:3]
        dxk = dx[GDIM:].reshape(len(fids), KDIM)
        w = dxk[:, 3:6]
        dRk = imu_factors._exp_so3_b(w)
        Vk = imu_factors._jl_so3_b(w)
        nxt = object.__new__(_Stacked)
        nxt.R = dRk @ cur.R
        nxt.t = (dRk @ cur.t[..., None])[..., 0] \
            + (Vk @ dxk[:, 0:3, None])[..., 0]
        nxt.aff = cur.aff + dxk[:, 6:8]
        nxt.v = cur.v + dxk[:, 8:11]
        nxt.bg = cur.bg + dxk[:, 11:14]
        nxt.ba = cur.ba + dxk[:, 14:17]
        e_n = pair_energy(nxt, s_n, g_n) + quad_energy(
            delta_vec(nxt, s_n, g_n))
        if np.isfinite(e_n) and e_n < e_cur:
            converged = float(np.max(np.abs(dx))) < 1e-7
            cur, s_log, g2, e_cur = nxt, s_n, g_n, e_n
            lam = max(lam * 0.25, 1e-8)
            if converged:
                break
        else:
            lam *= 4.0
            if lam > 1e6:
                break

    # Scale marginal variance: [H^-1]_00 via one solve (no full inverse).
    Hp, _ = pair_system(cur, s_log, g2)
    H = Hp + H_quad
    e0 = np.zeros(C)
    e0[0] = 1.0
    Hr = H.copy()
    np.einsum("ii->i", Hr)[:] += 1e-9
    x0 = _psd_solve(Hr, e0)
    s_var = float(x0[0]) if x0 is not None else float("inf")

    states = {
        f: KFState(R_cw=cur.R[k], t_cw=cur.t[k], aff=cur.aff[k],
                   v=cur.v[k], bg=cur.bg[k], ba=cur.ba[k])
        for k, f in enumerate(fids)}
    ok = np.isfinite(e_cur) and np.isfinite(s_var)
    return PGBAResult(ok=ok, s_log=s_log, g2=g2, states=states,
                      s_var=s_var, energy=e_cur, n_kfs=len(fids))


def _pair_residual_np(p, states: Dict[int, KFState],
                      s_log: float, g2: np.ndarray,
                      R_cb: np.ndarray, t_cb: np.ndarray) -> np.ndarray:
    """Weighted 15-dim residual of one pair at given states (host f64),
    through the camera-IMU extrinsic chain (imu_factors residual).
    Kept for tests/diagnostics; the LM loop uses the batched path."""
    from dmvio_tpu_torch.models.delayed import pair_weights

    r, _J = imu_factors.linearize_pair(
        states[p.fid_i], states[p.fid_j], p.pre, s_log, np.asarray(g2),
        R_cb, t_cb)
    W9, Wb = pair_weights(p.pre)
    return np.concatenate([W9 @ r[:9], Wb @ r[9:]])
