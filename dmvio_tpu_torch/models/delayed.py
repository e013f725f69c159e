# Copy of dmvio_tpu/models/delayed.py (NumPy only): the port keeps its own
# copy so that it imports nothing of the JAX package.
"""Delayed marginalization: a replayable log of marginalization events.

TPU-native re-design of DelayedMarginalization
(src/GTSAMIntegration/DelayedMarginalization.{h,cpp}): the reference keeps
a SECOND factor graph whose marginalizations run `delay` keyframes behind
the main one, so the recent history stays un-marginalized and can be
re-optimized (PGBA) before being folded into a prior.

Here the same capability is a DATA-STRUCTURE: every keyframe
marginalization appends an event capturing exactly what the main prior
absorbed — the dense visual/prior quadratic (at its FEJ) and the IMU pair
factors (kept SYMBOLIC: preintegrated measurements + frame ids, so PGBA can
relinearize them with poses free, the crucial property the reference gets
from keeping nonlinear factors in the delayed graph). Events older than the
delay are "advanced": their victim's coordinates are Schur-eliminated into
a tail prior (the FIFO replay of readvanceUntilDelay,
DelayedMarginalization.cpp:212-253). All algebra is host float64 (see
vio_ba.schur_out_np rationale).

Per-keyframe coordinate layout used by events, the tail, and PGBA:
    [xi(6), aff(2) -- visual | v(3), bg(3), ba(3) -- inertial]  (17)
plus global [s_log, g2x, g2y] (3).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

KDIM = 17          # per-keyframe coords
GDIM = 3           # global scale + gravity coords


@dataclasses.dataclass
class KFState:
    """Host snapshot of one keyframe's linearization state."""

    R_cw: np.ndarray
    t_cw: np.ndarray
    aff: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    ba: np.ndarray


@dataclasses.dataclass
class MargEvent:
    victim: int                      # keyframe id being marginalized
    fids: List[int]                  # involved keyframe ids (window at event)
    H: np.ndarray                    # [n*17+3, n*17+3] float64 quadratic
    b0: np.ndarray                   # gradient at `fej`
    fej: Dict[int, KFState]          # linearization states per involved fid
    s_log0: float
    g20: np.ndarray


@dataclasses.dataclass
class SymbolicPair:
    """A relinearizable IMU preintegration factor between two keyframes."""

    fid_i: int
    fid_j: int
    pre: dict                        # host float64 preint (preintegrate_np
                                     # fields or device fetch)


class DelayedLog:
    """Bounded FIFO of marginalization events + symbolic IMU pairs.

    R_cb/t_cb: camera-IMU extrinsics. Every pair (re)linearization runs
    through the full TransformDSOToIMU chain with the REAL calibration
    (the reference carries T_cam_imu everywhere,
    PoseTransformationIMU.h:45-133); round 1 passed identity here, which
    silently mis-frames scale/gravity on any rotated rig. Default delay
    matches the reference (init_pgbaDelay=100, IMUInitSettings.h:62)."""

    def __init__(self, delay: int = 100,
                 R_cb: Optional[np.ndarray] = None,
                 t_cb: Optional[np.ndarray] = None):
        self.delay = delay
        self.R_cb = (np.eye(3) if R_cb is None
                     else np.asarray(R_cb, np.float64))
        self.t_cb = (np.zeros(3) if t_cb is None
                     else np.asarray(t_cb, np.float64))
        self.events: Deque[MargEvent] = deque()
        self.pairs: List[SymbolicPair] = []
        # Tail prior over retired keyframes' still-referenced coords.
        self.tail_fids: List[int] = []
        self.tail_H: Optional[np.ndarray] = None
        self.tail_b0: Optional[np.ndarray] = None
        self.tail_fej: Dict[int, KFState] = {}
        self.tail_s0: float = 0.0
        self.tail_g20: np.ndarray = np.zeros(2)

    def snapshot(self) -> "DelayedLog":
        """O(#events) pointer-copy snapshot for the background PGBA thread.

        Safe because the log is copy-on-write by construction: events and
        symbolic pairs are immutable after record_event (their H/b0/fej
        arrays are freshly built by the recorder and never written again),
        and _advance REPLACES tail_H/tail_b0/tail_fej with new objects
        rather than mutating them in place. Replaces a per-PGBA-cycle
        copy.deepcopy of ~100 events (~15 MB + thousands of host objects,
        all under the GIL)."""
        snap = DelayedLog(delay=self.delay, R_cb=self.R_cb, t_cb=self.t_cb)
        snap.events = deque(self.events)
        snap.pairs = list(self.pairs)
        snap.tail_fids = list(self.tail_fids)
        snap.tail_H = self.tail_H
        snap.tail_b0 = self.tail_b0
        snap.tail_fej = dict(self.tail_fej)
        snap.tail_s0 = self.tail_s0
        snap.tail_g20 = self.tail_g20
        return snap

    # -- recording ---------------------------------------------------------
    def record_event(self, ev: MargEvent,
                     pairs: List[SymbolicPair]) -> None:
        self.events.append(ev)
        self.pairs.extend(pairs)
        while len(self.events) > self.delay:
            self._advance(self.events.popleft())

    # -- fifo advance ------------------------------------------------------
    def _coords(self, fids: List[int]) -> Dict[int, int]:
        return {f: GDIM + k * KDIM for k, f in enumerate(fids)}

    def _advance(self, ev: MargEvent) -> None:
        """Fold an expired event into the tail and eliminate its victim
        (the FIFO replay step)."""
        # Union coordinate system: tail fids + event fids.
        fids = list(dict.fromkeys(self.tail_fids + ev.fids))
        off = self._coords(fids)
        C = GDIM + len(fids) * KDIM
        H = np.zeros((C, C))
        b = np.zeros(C)
        fej: Dict[int, KFState] = dict(self.tail_fej)
        for f, st in ev.fej.items():
            fej.setdefault(f, st)

        def scatter(Hs, bs, src_fids, src_fej):
            src_off = {f: GDIM + k * KDIM for k, f in enumerate(src_fids)}
            idx = np.concatenate(
                [np.arange(GDIM)] +
                [off[f] + np.arange(KDIM) for f in src_fids])
            sidx = np.concatenate(
                [np.arange(GDIM)] +
                [src_off[f] + np.arange(KDIM) for f in src_fids])
            H[np.ix_(idx, idx)] += Hs[np.ix_(sidx, sidx)]
            # Transport b to the UNION fej: where the union fej differs
            # from the source fej, shift b by H * delta.
            delta = np.zeros(len(sidx))
            for k, f in enumerate(src_fids):
                if f in fej and f in src_fej:
                    d = _state_delta(fej[f], src_fej[f])
                    delta[GDIM + k * KDIM: GDIM + (k + 1) * KDIM] = d
            b[idx] += bs[sidx] + Hs[np.ix_(sidx, sidx)] @ delta

        if self.tail_H is not None:
            scatter(self.tail_H, self.tail_b0, self.tail_fids, self.tail_fej)
        scatter(ev.H, ev.b0, ev.fids, ev.fej)

        # Linearize + fold expired symbolic pairs touching the victim.
        keep_pairs = []
        for p in self.pairs:
            if p.fid_i == ev.victim or p.fid_j == ev.victim:
                if p.fid_i in off and p.fid_j in off:
                    Hp, bp, idx = _linearize_pair(
                        p, fej, off, ev.s_log0, ev.g20,
                        self.R_cb, self.t_cb)
                    H[np.ix_(idx, idx)] += Hp
                    b[idx] += bp
            else:
                keep_pairs.append(p)
        self.pairs = keep_pairs

        # Schur-eliminate the victim's coords.
        from dmvio_tpu_torch.models.vio_ba import schur_out_np

        if ev.victim in off:
            m = np.zeros(C, bool)
            m[off[ev.victim] + np.arange(KDIM)] = True
            H, b = schur_out_np(H, b, m)
        keep = [f for f in fids if f != ev.victim]
        kidx = np.concatenate(
            [np.arange(GDIM)] + [off[f] + np.arange(KDIM) for f in keep])
        self.tail_H = H[np.ix_(kidx, kidx)]
        self.tail_b0 = b[kidx]
        self.tail_fids = keep
        self.tail_fej = {f: fej[f] for f in keep if f in fej}
        self.tail_s0 = ev.s_log0
        self.tail_g20 = np.asarray(ev.g20)

    # -- marginalization replacement ---------------------------------------
    def rebuild_prior(self, window_fids: List[int],
                      target_fej: Dict[int, "KFState"],
                      relin: Dict[int, "KFState"],
                      s_log: float, g2: np.ndarray):
        """Re-derive the main marginalization prior from the full logged
        history at a better linearization point — the reference's
        marginalization replacement (prepareGraphForMainOptimization
        readvances the delayed graph to delay 0 and swaps it in as the main
        graph, PoseGraphBundleAdjustment.cpp:508;
        DelayedMarginalization.cpp:212-264).

        window_fids: keyframes that stay as free variables (current window).
        target_fej:  their linearization states (the window's FEJ) — the
                     returned prior's gradient is expressed there.
        relin:       refined states (PGBA result) used to (re)linearize the
                     symbolic IMU pairs and as the elimination point for
                     retired keyframes.
        s_log, g2:   adopted global values = the new global FEJ.

        Returns (H, b0) over [s, g2 | window_fids x 17] (float64), or None
        when the log cannot cover the window."""
        fids = list(dict.fromkeys(
            self.tail_fids
            + [f for ev in self.events for f in ev.fids]
            + [f for p in self.pairs for f in (p.fid_i, p.fid_j)]
            + list(window_fids)))
        off = self._coords(fids)
        C = GDIM + len(fids) * KDIM
        H = np.zeros((C, C))
        b = np.zeros(C)

        # Elimination/relinearization point: refined states everywhere we
        # have them; window FEJ for window fids; event fej as fallback.
        point: Dict[int, KFState] = {}
        for ev in self.events:
            for f, st in ev.fej.items():
                point.setdefault(f, st)
        for f, st in self.tail_fej.items():
            point.setdefault(f, st)
        point.update(relin)
        for f in window_fids:
            if f in target_fej:
                point[f] = target_fej[f]
        if any(f not in point for f in fids):
            return None

        def scatter(Hs, bs, src_fids, src_fej, src_s0, src_g20):
            src_off = {f: GDIM + k * KDIM for k, f in enumerate(src_fids)}
            idx = np.concatenate(
                [np.arange(GDIM)] +
                [off[f] + np.arange(KDIM) for f in src_fids])
            sidx = np.concatenate(
                [np.arange(GDIM)] +
                [src_off[f] + np.arange(KDIM) for f in src_fids])
            Hsub = Hs[np.ix_(sidx, sidx)]
            delta = np.zeros(len(sidx))
            delta[0] = s_log - src_s0
            delta[1:3] = np.asarray(g2) - np.asarray(src_g20)
            for k, f in enumerate(src_fids):
                if f in src_fej:
                    delta[GDIM + k * KDIM: GDIM + (k + 1) * KDIM] = \
                        _state_delta(point[f], src_fej[f])
            H[np.ix_(idx, idx)] += Hsub
            b[idx] += bs[sidx] + Hsub @ delta

        if self.tail_H is not None:
            scatter(self.tail_H, self.tail_b0, self.tail_fids,
                    self.tail_fej, self.tail_s0, self.tail_g20)
        for ev in self.events:
            scatter(ev.H, ev.b0, ev.fids, ev.fej, ev.s_log0, ev.g20)
        # Relinearize every logged IMU pair at the refined states — the
        # whole point of the delay: these factors re-enter the prior with
        # Jacobians at the adopted scale/gravity.
        for p in self.pairs:
            Hp, bp, idx = _linearize_pair(p, point, off, s_log,
                                          np.asarray(g2),
                                          self.R_cb, self.t_cb)
            H[np.ix_(idx, idx)] += Hp
            b[idx] += bp

        # Eliminate everything outside the window in one Schur step.
        from dmvio_tpu_torch.models.vio_ba import schur_out_np

        gone = [f for f in fids if f not in window_fids]
        if gone:
            m = np.zeros(C, bool)
            for f in gone:
                m[off[f] + np.arange(KDIM)] = True
            H, b = schur_out_np(H, b, m)
        kidx = np.concatenate(
            [np.arange(GDIM)] +
            [off[f] + np.arange(KDIM) for f in window_fids])
        return H[np.ix_(kidx, kidx)], b[kidx]

    # -- queries -----------------------------------------------------------
    def delayed_fids(self) -> List[int]:
        """All keyframe ids with un-marginalized (replayable) state,
        including tail-prior variables (they still carry information)."""
        out: List[int] = list(self.tail_fids)
        for ev in self.events:
            for f in ev.fids:
                if f not in out:
                    out.append(f)
        for p in self.pairs:
            for f in (p.fid_i, p.fid_j):
                if f not in out:
                    out.append(f)
        return sorted(out)


def _state_delta(cur: KFState, ref: KFState) -> np.ndarray:
    """[17] delta = cur (-) ref in the event coordinate convention."""
    from dmvio_tpu_torch.models.vio_coarse import _log_so3

    dR = cur.R_cw @ ref.R_cw.T
    w = _log_so3(dR)
    # left-increment translation component: t_cur - dR t_ref has rotation
    # part folded; use exact se3 log via small-angle (host, float64).
    V = _left_jac_np(w)
    dt = cur.t_cw - dR @ ref.t_cw
    vpart = np.linalg.solve(V, dt)
    return np.concatenate([
        vpart, w, cur.aff - ref.aff, cur.v - ref.v,
        cur.bg - ref.bg, cur.ba - ref.ba])


def _left_jac_np(w):
    t = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if t < 1e-8:
        return np.eye(3) + 0.5 * W + W @ W / 6.0
    return (np.eye(3) + (1 - np.cos(t)) / (t * t) * W
            + (t - np.sin(t)) / (t ** 3) * W @ W)


def pair_weights(pre: dict):
    """Sqrt-information of one pair: (W9 over [r_R, r_v, r_p], Wb over the
    bias walk). The small inflation keeps long-chunk preintegration
    covariances invertible and matches round 1's FD implementation."""
    from dmvio_tpu_torch.ops import preint as P

    infl = np.diag(np.concatenate([
        np.full(3, 1e-3 ** 2), np.full(3, 0.01 ** 2),
        np.full(3, 0.003 ** 2)]))
    W9 = np.linalg.inv(np.linalg.cholesky(
        np.asarray(pre["cov"]) + infl + 1e-14 * np.eye(9)))
    dt = float(pre["dt"])
    Wb = np.diag(np.concatenate([
        np.full(3, 1.0 / (P.NOISE.sigma_gyro_walk * np.sqrt(max(dt, 1e-6)))),
        np.full(3, 1.0 / (P.NOISE.sigma_acc_walk * np.sqrt(max(dt, 1e-6))))]))
    return W9, Wb


def pair_weights_batch(pres: List[dict]):
    """Batched pair_weights over N preints: (W9 [N,9,9], Wb [N,6,6]).
    Same formulas; np.linalg batches the 9x9 cholesky/inverse."""
    from dmvio_tpu_torch.ops import preint as P

    infl = np.diag(np.concatenate([
        np.full(3, 1e-3 ** 2), np.full(3, 0.01 ** 2),
        np.full(3, 0.003 ** 2)]))
    cov = np.stack([np.asarray(p["cov"], np.float64) for p in pres])
    W9 = np.linalg.inv(np.linalg.cholesky(
        cov + infl + 1e-14 * np.eye(9)))
    dt = np.maximum(np.asarray([float(p["dt"]) for p in pres]), 1e-6)
    sg = 1.0 / (P.NOISE.sigma_gyro_walk * np.sqrt(dt))
    sa = 1.0 / (P.NOISE.sigma_acc_walk * np.sqrt(dt))
    Wb = np.zeros((len(pres), 6, 6))
    for k in range(3):
        Wb[:, k, k] = sg
        Wb[:, 3 + k, 3 + k] = sa
    return W9, Wb


def _linearize_pair(p: SymbolicPair, fej: Dict[int, KFState],
                    off: Dict[int, int], s_log: float, g2: np.ndarray,
                    R_cb: np.ndarray, t_cb: np.ndarray):
    """Host float64 ANALYTIC linearization of one IMU pair at the given
    states (models/imu_factors.py), through the full camera-IMU extrinsic
    chain.

    Returns (H [33 x 33], b, global index array) over
    [s,g2 | i-block 17 | j-block 17] mapped through `off` (aff columns are
    zero — IMU factors do not touch brightness)."""
    from dmvio_tpu_torch.models import imu_factors

    r, J = imu_factors.linearize_pair(
        fej[p.fid_i], fej[p.fid_j], p.pre, s_log, np.asarray(g2),
        R_cb, t_cb)
    W9, Wb = pair_weights(p.pre)
    Jw = np.concatenate([W9 @ J[:9], Wb @ J[9:]], axis=0)
    rw = np.concatenate([W9 @ r[:9], Wb @ r[9:]])

    H = Jw.T @ Jw
    b = Jw.T @ rw
    # Map local [s,g2, i(15: xi6+v3+b6), j(15)] to the 17-dim blocks
    # (skip aff columns).
    idx = np.concatenate([
        np.arange(GDIM),
        off[p.fid_i] + np.concatenate([np.arange(6), 8 + np.arange(9)]),
        off[p.fid_j] + np.concatenate([np.arange(6), 8 + np.arange(9)]),
    ])
    return H, b, idx
