"""IMU side-state of the full system: buffers, init machine, VIO window.

Counterpart of dmvio_tpu/models/imu_system.py (the IMUIntegration facade +
IMUInitializer state machine), serial path: the per-frame / per-keyframe
measurement buffers, the gravity bootstrap, the coarse IMU init window, the
extended VIO prior (HM over C_ext, host float64), the per-slot velocity and
bias states (device tensors), the keyframe-to-keyframe preintegration
pairs, the delayed-marginalization log and the PGBA cycle. FullSystem calls
into it at the reference's seams.

Init phases:
    INACTIVE -> COARSE_INIT (visual ready, collecting poses)
             -> ACTIVE      (scale variance below threshold; VIO BA on)

Preintegration runs on the host in float64 (`preint.preintegrate_np`) and
is uploaded once per use. Pairs are (older slot, newer slot, host preint
dict). The realtime pipeline adds its seams: frame-id-tagged chunks (the
keyframe-to-keyframe chunk stops at a keyframe decided frames late), the
non-mutating multi-chunk preview prediction, the asynchronous PGBA
snapshot copy and PGBA on a background thread. Not ported: the
tracker-sigma init weighting that the reference keeps off by default.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from dmvio_tpu_torch.models import delayed, imu_init, pgba, vio_ba
from dmvio_tpu_torch.models import vio_coarse
from dmvio_tpu_torch.ops import ba_solve, preint
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.fetch import to_host
from dmvio_tpu_torch.utils.timing import TimeMeasurement

# Rolling init window length (reference maxNumPoses, IMUInitSettings.h:38).
INIT_WINDOW = 100

INACTIVE, COARSE_INIT, ACTIVE = 0, 1, 2


@dataclasses.dataclass
class IMUCalib:
    """Camera-IMU calibration (reference IMUCalibration, IMUSettings.h:126)
    and the IMU-init transition knobs (see the reference's IMUCalib)."""

    R_cb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    t_cb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32))
    sigma_gyro: float = 1.6968e-4
    sigma_acc: float = 2.0e-3
    sigma_gyro_walk: float = 8.0e-5
    sigma_acc_walk: float = 3.0e-3
    sigma_integration: float = 1e-8
    # 2 = full method (PGBA + marginalization replacement), 1 = no
    # replacement, 4 = no replacement at the first takeover, 5 = coarse
    # IMU init only (no PGBA).
    transition_model: int = 2
    coarse_scale_th: float = 1.0
    pgba_scale_th: float = 1.0
    pgba_delay: int = 100
    pgba_max_kfs: int = 100
    pgba_every: int = 6


def _stack_np(pres_np: List[dict]) -> dict:
    """Stack host preint dicts field by field (float32, as uploaded)."""
    return {f: np.stack([np.asarray(p[f], np.float32) for p in pres_np])
            for f in preint.PreintState._fields}


def _identity_np() -> dict:
    z33 = np.zeros((3, 3))
    return dict(dR=np.eye(3), dv=np.zeros(3), dp=np.zeros(3), dt=0.0,
                dR_dbg=z33, dv_dbg=z33, dv_dba=z33, dp_dbg=z33, dp_dba=z33,
                cov=np.zeros((9, 9)), bias_lin=np.zeros(6))


def _seed_slot_states(st: vio_ba.VIOStates, new_slot: int, prev_slot: int,
                      v_pred: Optional[np.ndarray]) -> vio_ba.VIOStates:
    """Seed a fresh keyframe slot's inertial states from its predecessor
    (velocity from the coarse prediction when available)."""
    if v_pred is not None:
        v_new = torch.as_tensor(np.asarray(v_pred, np.float32),
                                device=st.v.device)
    else:
        v_new = st.v[prev_slot]

    def put(a, val):
        a = a.clone()
        a[new_slot] = val
        return a
    return st._replace(
        v=put(st.v, v_new), v0=put(st.v0, v_new),
        bg=put(st.bg, st.bg[prev_slot]), bg0=put(st.bg0, st.bg[prev_slot]),
        ba=put(st.ba, st.ba[prev_slot]), ba0=put(st.ba0, st.ba[prev_slot]))


class IMUSystem:
    """All inertial state surrounding the visual window."""

    # Scale-fix (finishKeyframeOperations, BAIMULogic.cpp:457-497): once
    # the scale is stable over a window of keyframes, pin scale/gravity.
    SCALE_FIX_WINDOW = 6
    SCALE_FIX_TH = 1.03

    def __init__(self, calib: IMUCalib, f_max: int, device):
        self.calib = calib
        self.f_max = f_max
        self.device = device
        # The calibration is the single source of the process noise model.
        preint.set_noise(
            sigma_gyro=calib.sigma_gyro, sigma_acc=calib.sigma_acc,
            sigma_gyro_walk=calib.sigma_gyro_walk,
            sigma_acc_walk=calib.sigma_acc_walk,
            sigma_integration=calib.sigma_integration)
        self.R_cb = torch.as_tensor(np.asarray(calib.R_cb, np.float32),
                                    device=device)
        self.t_cb = torch.as_tensor(np.asarray(calib.t_cb, np.float32),
                                    device=device)
        self.phase = INACTIVE
        # Gravity bootstrap accumulator (GravityInitializer.cpp:29-85).
        self._acc_sum = np.zeros(3)
        self._acc_n = 0
        # KF-chunk raw buffer (samples since the last keyframe).
        self._kf_acc: List[np.ndarray] = []
        self._kf_gyr: List[np.ndarray] = []
        self._kf_dts: List[np.ndarray] = []
        self._kf_fids: List[int] = []   # frame id per buffered chunk
        # Coarse-init rolling window: poses relative to their tracking
        # reference + frame-to-frame host preints.
        self._init_poses: List[Tuple[np.ndarray, np.ndarray, int]] = []
        self._init_pres: List[dict] = []
        self._init_fids: List[int] = []
        self._init_dts: List[float] = []
        self.init_result: Optional[imu_init.CoarseInitResult] = None
        self._last_init_decent = False
        # VIO window state (valid in ACTIVE phase).
        self.states: Optional[vio_ba.VIOStates] = None
        self.pairs: List[Tuple[int, int, dict]] = []
        self.HM = None
        self.bM0 = None
        self.prior_diag = None
        self.init_s_var = 1.0
        self.coarse: Optional[vio_coarse.CoarseIMUState] = None
        self.last_frame_pre_np: Optional[dict] = None
        self._last_chunk_acc_mean = None
        self.s_log = 0.0
        self.g2 = np.zeros(2)
        self.delayed_log = delayed.DelayedLog(
            delay=calib.pgba_delay, R_cb=calib.R_cb, t_cb=calib.t_cb)
        self.kf_since_pgba = 0
        self.pgba_count = 0
        self.pgba_adopt_count = 0
        self.best_pgba_var = float("inf")
        self.last_pgba_svar = None
        self._pgba_adopted_once = False
        self.scale_fixed = False
        self._s_hist: List[float] = []
        self._device_pairs_cache = None
        self._device_pairs_key = ()
        # Keyframe-to-keyframe preints recorded before ACTIVE, fid-keyed;
        # consumed by activate().
        self._pending_pairs: List[Tuple[int, int, dict]] = []
        # Realtime pipeline: the preview's prefix cache, the asynchronous
        # PGBA snapshot in flight, and the background PGBA run. FullSystem
        # sets pgba_background to cfg.realtime (the serial mode stays
        # deterministic).
        self._preview_cache = None
        self._pgba_pending = None
        self._pgba_bg = None
        self.pgba_background = False

    def clear_init_window(self) -> None:
        """Drop the init window and the KF-chunk buffer (after a visual
        re-initialization the recorded poses live at another scale)."""
        for buf in (self._init_poses, self._init_pres, self._init_fids,
                    self._init_dts, self._kf_acc, self._kf_gyr,
                    self._kf_dts, self._kf_fids):
            buf.clear()

    # -- per-frame ingestion ------------------------------------------------
    def add_frame_imu(self, acc, gyr, dts, fid: int = -1) -> None:
        """Buffer one frame's measurements and preintegrate the frame
        chunk on the host in float64 (the coarse filter and the init window
        both consume it). `fid` tags the chunk with its frame id, so that a
        keyframe decided frames late (realtime) can split the
        keyframe-to-keyframe buffer at its own frame."""
        if len(dts) == 0:
            self.last_frame_pre_np = None
            self._last_chunk_acc_mean = None
            return
        self._last_chunk_acc_mean = np.asarray(acc).mean(axis=0)
        self._kf_acc.append(np.asarray(acc, np.float32))
        self._kf_gyr.append(np.asarray(gyr, np.float32))
        self._kf_dts.append(np.asarray(dts, np.float32))
        self._kf_fids.append(int(fid))
        bias_np = (self.coarse.bias if self.coarse is not None
                   else np.zeros(6))
        self.last_frame_pre_np = preint.preintegrate_np(acc, gyr, dts,
                                                        bias_np)

    def frame_chunk(self) -> Optional[dict]:
        """Snapshot of the just-ingested frame chunk, for the realtime
        pipeline, which consumes a frame after newer chunks have
        overwritten `last_frame_pre_np`."""
        if self.last_frame_pre_np is None:
            return None
        return dict(pre_np=self.last_frame_pre_np,
                    acc_mean=self._last_chunk_acc_mean)

    def gravity_guess(self) -> np.ndarray:
        if self._acc_n == 0:
            return np.zeros(2)
        mean = torch.as_tensor(np.asarray(self._acc_sum / self._acc_n,
                                          np.float32))
        return imu_init.gravity_from_accel(mean).numpy()

    # -- tracking-side (coarse, host float64) ------------------------------
    def predict_coarse(self, chunk_np: Optional[dict] = None):
        """Propagate the coarse belief through one frame chunk: the last
        ingested by default; the realtime pipeline passes the consumed
        frame's own chunk."""
        if chunk_np is None:
            chunk_np = self.last_frame_pre_np
        if self.phase != ACTIVE or self.coarse is None or chunk_np is None:
            return None
        with TimeMeasurement("imu_predict"):
            self.coarse = vio_coarse.predict(
                self.coarse, chunk_np,
                np.asarray(self.calib.R_cb, np.float64),
                np.asarray(self.calib.t_cb, np.float64))
        return self.coarse

    def predict_preview(self, chunks_np) -> Optional[
            vio_coarse.CoarseIMUState]:
        """Non-mutating prediction through a list of frame chunks: the
        realtime dispatch-time prediction. The belief sits at the last
        consumed frame; the in-flight frames' chunks and the new frame's
        are propagated through a copy. None without a belief or on a chunk
        gap (a None entry), which breaks the chain.

        Incremental: when the belief is the same object as at the previous
        call and that call's chunk list is a prefix of this one, only the
        new suffix is propagated. Identity keys are sound because chunk
        dicts are snapshots the realtime queue holds unchanged, and every
        belief update rebinds `self.coarse`."""
        if self.phase != ACTIVE or self.coarse is None:
            return None
        if any(ch is None for ch in chunks_np):
            return None
        key = tuple(id(ch) for ch in chunks_np)
        state, todo = self.coarse, chunks_np
        cached = self._preview_cache
        if cached is not None and cached[0] is self.coarse \
                and key[:len(cached[1])] == cached[1]:
            state = cached[2]
            todo = chunks_np[len(cached[1]):]
        R_cb = np.asarray(self.calib.R_cb, np.float64)
        t_cb = np.asarray(self.calib.t_cb, np.float64)
        with TimeMeasurement("imu_predict"):
            for ch in todo:
                state = vio_coarse.predict(state, ch, R_cb, t_cb)
        # The chunk dicts stay referenced by the cache, so their ids cannot
        # be reused by new chunks while the key is live.
        self._preview_cache = (self.coarse, key, state, list(chunks_np))
        return state

    def coarse_prior(self, R_ref_np, t_ref_np, rho0, b0):
        if self.phase != ACTIVE or self.coarse is None:
            return None
        return vio_coarse.make_tracker_prior(
            self.coarse, np.asarray(R_ref_np, np.float64),
            np.asarray(t_ref_np, np.float64), float(rho0), float(b0),
            self.device)

    def fuse_tracked(self, H_vis8_np, R_cw_np, t_cw_np, v_np, bias_np):
        if self.phase != ACTIVE or self.coarse is None:
            return
        self.coarse = vio_coarse.fuse_visual(
            self.coarse, H_vis8_np, R_cw_np, t_cw_np, v_np, bias_np)

    # -- init machine -------------------------------------------------------
    def record_init_pose(self, fid: int, ref_fid: int, R_rel, t_rel,
                         R_cw_approx, chunk: Optional[dict] = None) -> None:
        """Feed a tracked-frame pose (relative to its tracking-reference
        keyframe, resolved against the latest optimized keyframe poses at
        init time) and its chunk into the init window. `chunk` is the
        frame's own frame_chunk() in realtime mode, where the last chunk
        has moved on by consume time."""
        if chunk is None:
            chunk = self.frame_chunk()
        if self.phase == ACTIVE or chunk is None:
            return
        if chunk["acc_mean"] is not None:
            # Body-frame specific force -> camera frame (R_cb) -> DSO world
            # (tracked attitude), averaged for the gravity bootstrap.
            self._acc_sum += np.asarray(R_cw_approx).T @ (
                np.asarray(self.calib.R_cb, np.float64) @ chunk["acc_mean"])
            self._acc_n += 1
        self._init_poses.append((np.asarray(R_rel), np.asarray(t_rel),
                                 ref_fid))
        self._init_pres.append(chunk["pre_np"])
        self._init_fids.append(fid)
        self._init_dts.append(float(chunk["pre_np"]["dt"]))
        if len(self._init_poses) > INIT_WINDOW:
            for buf in (self._init_poses, self._init_pres, self._init_fids,
                        self._init_dts):
                buf.pop(0)

    def _resolve_init_poses(self, kf_poses: dict):
        """Absolute DSO poses of the init window against the latest
        optimized keyframe poses (consistent chain)."""
        out = []
        for k, (R_rel, t_rel, ref_fid) in enumerate(self._init_poses):
            fid = self._init_fids[k]
            if fid in kf_poses:
                out.append((kf_poses[fid][0], kf_poses[fid][1]))
            elif ref_fid in kf_poses:
                R_ref, t_ref = kf_poses[ref_fid]
                out.append((R_rel @ R_ref, R_rel @ t_ref + t_rel))
            else:
                out.append(None)
        return out

    def init_velocity_of(self, fid: int) -> Optional[np.ndarray]:
        if self.init_result is None or fid not in self._init_fids:
            return None
        k = self._init_fids.index(fid)
        return np.asarray(self.init_result.v[k])

    def try_initialize(self, kf_poses: dict) -> bool:
        """Run the coarse IMU init over the pose window; True when the
        scale estimate is trustworthy (scale-marginal threshold,
        IMUInitSettings.h:64) and the optimizer converged."""
        n = len(self._init_poses)
        if n < 24:
            return False
        dev = self.device
        with TimeMeasurement("imu_coarse_init"):
            N = imu_init.N_MAX
            resolved = self._resolve_init_poses(kf_poses)
            if any(p is None for p in resolved):
                return False
            Rs = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
            ts = np.zeros((N, 3), np.float32)
            for k, (R, t) in enumerate(resolved):
                Rs[k] = R
                ts[k] = t
            pres = list(self._init_pres[1:n])
            pres += [_identity_np()] * (N - 1 - len(pres))
            st = imu_init.CoarseInitState(
                R_cw=torch.as_tensor(Rs, device=dev),
                t_cw=torch.as_tensor(ts, device=dev),
                pre=preint.state_from_np(_stack_np(pres), dev),
                valid=torch.arange(N, device=dev) < n)
            warm = self.init_result is not None and self._last_init_decent
            g20 = np.asarray(self.init_result.g2) if warm \
                else self.gravity_guess()
            s0 = float(self.init_result.s_log) if warm else 0.0
            b0 = np.asarray(self.init_result.bias) if warm else np.zeros(6)
            # Velocity initialization from pose finite differences in the
            # (guessed) metric frame.
            v0_np = np.zeros((N, 3), np.float32)
            R_g = lie.so3_exp(torch.tensor([g20[0], g20[1], 0.0],
                                           dtype=torch.float32)).numpy()
            s_guess = np.exp(s0)
            p_m = []
            for (R, t) in resolved:
                t_wc = -R.T @ t
                p_m.append((R_g.T @ t_wc) / s_guess)
            for k in range(n - 1):
                dtk = max(self._init_dts[k + 1]
                          if k + 1 < len(self._init_dts) else 0.05, 1e-3)
                v0_np[k] = (p_m[k + 1] - p_m[k]) / dtk
            if n >= 2:
                v0_np[n - 1] = v0_np[n - 2]
            v0 = np.asarray(self.init_result.v) if warm else v0_np

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)
            res = to_host(imu_init.optimize(
                st, self.R_cb, self.t_cb, s_log0=f32(s0), g20=f32(g20),
                bias0=f32(b0), v0=f32(v0), iters=25))
        self.init_result = res
        n_res = 9.0 * max(n - 1, 1)
        mean_e = float(res.energy) / n_res
        finite = np.isfinite(float(res.s_log)) and np.isfinite(mean_e)
        if not finite:
            # A diverged fit must not poison the next warm start.
            self.init_result = None
            self._last_init_decent = False
            return False
        self._last_init_decent = mean_e < 50.0
        return (bool(res.ok)
                and float(res.s_var) < self.calib.coarse_scale_th
                and mean_e < 5.0)

    def activate(self, slot_frame_ids, frame_vel_lookup) -> None:
        """Switch to ACTIVE: build VIO states and priors around the visual
        window; velocities of window keyframes come from the init window
        when available (frame_vel_lookup: frame id -> v [3] or None)."""
        F = self.f_max
        dev = self.device
        res = self.init_result
        self.s_log = float(res.s_log)
        self.g2 = np.asarray(res.g2)
        C = vio_ba.cdim_ext(F)
        self.HM = np.zeros((C, C), np.float64)
        self.bM0 = np.zeros((C,), np.float64)

        v = np.zeros((F, 3), np.float32)
        bg = np.tile(np.asarray(res.bias[:3], np.float32), (F, 1))
        ba_ = np.tile(np.asarray(res.bias[3:6], np.float32), (F, 1))
        for s in range(F):
            fid = slot_frame_ids[s]
            if fid is not None:
                vv = frame_vel_lookup(fid)
                if vv is not None:
                    v[s] = vv

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.states = vio_ba.VIOStates(
            v=t(v), bg=t(bg), ba=t(ba_), v0=t(v), bg0=t(bg), ba0=t(ba_),
            s_log=t(self.s_log), g2=t(self.g2), s_log0=t(self.s_log),
            g20=t(self.g2))

        # Extended priors: velocities, biases; scale/gravity pinned at the
        # coarse init values, at least as hard as sigma ~1% / 0.01 rad.
        prior = np.zeros(C, np.float32)
        for f in range(F):
            off = vio_ba.imu_offset(F, f)
            prior[off:off + 3] = 1.0 / (0.5 ** 2)        # velocity
            prior[off + 3:off + 6] = 1.0 / (0.01 ** 2)   # gyro bias
            prior[off + 6:off + 9] = 1.0 / (0.1 ** 2)    # accel bias
        Cg = ba_solve.cdim(F) + 9 * F
        s_var = float(getattr(res, "s_var", np.nan))
        if not np.isfinite(s_var) or s_var <= 0:
            s_var = 1.0
        prior[Cg] = max(1.0 / s_var, 1e4)
        prior[Cg + 1:Cg + 3] = 1e4
        # The init's honest scale marginal, for the delayed log's base
        # event (the window pin above is floored for stability).
        self.init_s_var = s_var
        self.prior_diag = prior

        # Chain the pre-activation keyframes that survived into the window.
        fid_to_slot = {f: s for s, f in enumerate(slot_frame_ids)
                       if f is not None}
        have = {(p[0], p[1]) for p in self.pairs}
        for pf, nf, pre_np in self._pending_pairs:
            sa, sb = fid_to_slot.get(pf), fid_to_slot.get(nf)
            if sa is None or sb is None or (sa, sb) in have:
                continue
            if len(self.pairs) >= F - 1:
                break
            self.pairs.append((sa, sb, pre_np))
            have.add((sa, sb))
        self._pending_pairs = []
        self.phase = ACTIVE

    # -- keyframe-side ------------------------------------------------------
    def kf_chunk_preint(self, upto_fid: Optional[int] = None
                        ) -> Optional[dict]:
        """Preintegrate everything since the last keyframe (host float64)
        and take it out of the buffer. `upto_fid` stops the chunk at the
        keyframe's own frame: in realtime mode younger frames' samples are
        already buffered by then; they belong to the next pair and stay."""
        if not self._kf_dts:
            return None
        if upto_fid is None:
            n_take = len(self._kf_dts)
        else:
            n_take = sum(1 for f in self._kf_fids if f <= int(upto_fid))
        if n_take == 0:
            return None
        acc = np.concatenate(self._kf_acc[:n_take])
        gyr = np.concatenate(self._kf_gyr[:n_take])
        dts = np.concatenate(self._kf_dts[:n_take])
        blin_np = np.zeros(6) if self.init_result is None else \
            np.asarray(self.init_result.bias)
        pre_np = preint.preintegrate_np(acc, gyr, dts, blin_np)
        for buf in (self._kf_acc, self._kf_gyr, self._kf_dts, self._kf_fids):
            del buf[:n_take]
        return pre_np

    def on_new_keyframe(self, prev_slot: int, new_slot: int,
                        pred_v: Optional[np.ndarray],
                        upto_fid: Optional[int] = None,
                        fids: Optional[tuple] = None) -> None:
        """Register the keyframe-to-keyframe pair and seed the new slot's
        states. fids = (previous keyframe's frame id, new one's): before
        ACTIVE the preintegration is kept fid-keyed for activate().
        upto_fid: see kf_chunk_preint."""
        pre_np = self.kf_chunk_preint(upto_fid)
        if self.phase != ACTIVE or self.states is None:
            if pre_np is not None and fids is not None \
                    and fids[0] is not None and fids[1] is not None:
                self._pending_pairs.append(
                    (int(fids[0]), int(fids[1]), pre_np))
                if len(self._pending_pairs) > 4 * self.f_max:
                    del self._pending_pairs[0]
            return
        if pre_np is not None and prev_slot is not None and prev_slot >= 0:
            self.pairs.append((prev_slot, new_slot, pre_np))
        self.states = _seed_slot_states(self.states, new_slot, prev_slot,
                                        pred_v)

    def device_pairs(self) -> vio_ba.IMUPairs:
        """Stacked device form of the window's pairs (Q = F-1, padded with
        identity preints), uploaded once and cached until the pair list
        changes."""
        key = tuple(id(t) for t in self.pairs)
        if self._device_pairs_cache is not None \
                and self._device_pairs_key == key:
            return self._device_pairs_cache
        Q = self.f_max - 1
        iis = np.zeros(Q, np.int64)
        jjs = np.zeros(Q, np.int64)
        val = np.zeros(Q, bool)
        pres = []
        for q, (i, j, pre_np) in enumerate(self.pairs[:Q]):
            iis[q], jjs[q], val[q] = i, j, True
            pres.append(pre_np)
        pres += [_identity_np()] * (Q - len(pres))
        dev = self.device
        out = vio_ba.IMUPairs(
            pre=preint.state_from_np(_stack_np(pres), dev),
            i=torch.as_tensor(iis, device=dev),
            j=torch.as_tensor(jjs, device=dev),
            valid=torch.as_tensor(val, device=dev))
        self._device_pairs_cache = out
        self._device_pairs_key = key
        # Keep the keyed tuples alive so a freed tuple's id cannot be
        # reused by a new pair and alias the cache.
        self._device_pairs_ref = list(self.pairs)
        return out

    def drop_pairs_touching(self, slots: List[int]):
        """Remove pairs that reference marginalized slots; returns them."""
        keep, removed = [], []
        for tup in self.pairs:
            (removed if tup[0] in slots or tup[1] in slots
             else keep).append(tup)
        self.pairs = keep
        return removed

    # -- delayed marginalization + PGBA ------------------------------------
    @staticmethod
    def build_kf_snapshot(pack, slot_fids):
        """Host KFState dict from fetched (R, t, aff, v, bg, ba) per-slot
        arrays."""
        R, t, aff, v, bg, ba = [np.asarray(x, np.float64) for x in pack]
        out = {}
        for slot, fid in enumerate(slot_fids):
            if fid is not None:
                out[fid] = delayed.KFState(
                    R_cw=R[slot].copy(), t_cw=t[slot].copy(),
                    aff=aff[slot].copy(), v=v[slot].copy(),
                    bg=bg[slot].copy(), ba=ba[slot].copy())
        return out

    def snapshot_fej(self, frames_dev, slot_fids):
        """Host KFState dict of the occupied slots' FEJ states (one device
        fetch)."""
        st = self.states
        return self.build_kf_snapshot(to_host(
            (frames_dev.R0_cw, frames_dev.t0_cw, frames_dev.aff0, st.v0,
             st.bg0, st.ba0)), slot_fids)

    def event_idx(self, slots) -> np.ndarray:
        """C_ext indices of the event layout [s, g2 | per-slot 17] (calib
        coords are dropped: the intrinsics are pinned by a huge prior)."""
        F = self.f_max
        Cv = ba_solve.cdim(F)
        Cg = Cv + 9 * F
        idx = [Cg, Cg + 1, Cg + 2]
        for slot in slots:
            idx.extend(range(ba_solve.CPART + 8 * slot,
                             ba_solve.CPART + 8 * slot + 8))
            idx.extend(range(Cv + 9 * slot, Cv + 9 * slot + 9))
        return np.asarray(idx)

    def cext_to_event(self, H_ext, b_ext, slots):
        """Remap a C_ext-layout quadratic onto the event layout."""
        idx = self.event_idx(slots)
        return (np.asarray(H_ext, np.float64)[np.ix_(idx, idx)],
                np.asarray(b_ext, np.float64)[idx])

    def record_base_event(self, frames_dev, slot_fids) -> None:
        """Log the activation-time prior as the delayed log's base
        quadratic (victim-less event), so a later marginalization
        replacement can re-derive the complete main prior from the log.
        Scale/gravity enter at the init's honest marginal, not the window
        pin (see the reference for the measurements behind this)."""
        if self.phase != ACTIVE or self.states is None:
            return
        slots = [s for s, f in enumerate(slot_fids) if f is not None]
        fids = [slot_fids[s] for s in slots]
        H_full = np.asarray(self.HM, np.float64).copy()
        if self.prior_diag is not None:
            H_full[np.diag_indices_from(H_full)] += np.asarray(
                self.prior_diag, np.float64)
            F = self.f_max
            Cg = ba_solve.cdim(F) + 9 * F
            sv = float(self.init_s_var)
            H_full[Cg, Cg] += (1.0 / max(sv, 1e-8)
                               - float(self.prior_diag[Cg]))
            for k_ in (1, 2):
                H_full[Cg + k_, Cg + k_] += (
                    min(float(self.prior_diag[Cg + k_]), 400.0)
                    - float(self.prior_diag[Cg + k_]))
        H_ev, b_ev = self.cext_to_event(H_full, self.bM0, slots)
        fej = self.snapshot_fej(frames_dev, slot_fids)
        st_np = to_host((self.states.s_log0, self.states.g20))
        self.delayed_log.record_event(delayed.MargEvent(
            victim=-1, fids=fids, H=H_ev, b0=b_ev,
            fej={f: fej[f] for f in fids if f in fej},
            s_log0=float(st_np[0]), g20=np.asarray(st_np[1])), [])

    def replace_prior_from_log(self, slot_fids, res, target) -> bool:
        """Marginalization replacement: swap the main prior for one
        re-derived from the delayed log at the PGBA-refined linearization
        point (prepareGraphForMainOptimization). `target`: the FEJ
        snapshot of the window."""
        F = self.f_max
        slots = [s for s, f in enumerate(slot_fids) if f is not None]
        window_fids = [slot_fids[s] for s in slots]
        out = self.delayed_log.rebuild_prior(
            window_fids, target, res.states, res.s_log, np.asarray(res.g2))
        if out is None:
            return False
        H_ev, b_ev = out
        if not (np.all(np.isfinite(H_ev)) and np.all(np.isfinite(b_ev))):
            return False
        C = vio_ba.cdim_ext(F)
        HM = np.zeros((C, C), np.float64)
        bM = np.zeros(C, np.float64)
        idx = self.event_idx(slots)
        HM[np.ix_(idx, idx)] = H_ev
        bM[idx] = b_ev
        self.HM = HM
        self.bM0 = bM
        return True

    def record_marg_event(self, victim_fid, slots, slot_fids, H_ext_add,
                          b_ext_add, removed_pairs, slot_fid_map,
                          fej_snapshot, st0) -> None:
        """Append one marginalization event + the victim's symbolic pairs
        to the delayed log (DelayedMarginalization.cpp:82)."""
        if self.phase != ACTIVE or self.states is None:
            return
        fids = [slot_fids[sl] for sl in slots]
        H_ev, b_ev = self.cext_to_event(H_ext_add, b_ext_add, slots)
        ev = delayed.MargEvent(
            victim=victim_fid, fids=fids, H=H_ev, b0=b_ev,
            fej={f: fej_snapshot[f] for f in fids if f in fej_snapshot},
            s_log0=float(st0[0]), g20=np.asarray(st0[1]))
        sym = []
        for i, j, pre_np in removed_pairs:
            fi = slot_fid_map.get(i)
            fj = slot_fid_map.get(j)
            if fi is not None and fj is not None:
                sym.append(delayed.SymbolicPair(fid_i=fi, fid_j=fj,
                                                pre=pre_np))
        self.delayed_log.record_event(ev, sym)

    def maybe_run_pgba(self, frames_dev, slot_fids,
                       active_event_fn=None, every: Optional[int] = None,
                       submit_fn=None) -> bool:
        """Trigger PGBA periodically; adopt its result when the scale
        marginal improves (threshold-gated transitions,
        IMUInitializerTransitions.h).

        In the serial mode everything runs here, synchronously. The
        realtime pipeline passes `submit_fn` (its fetcher's submit): the
        trigger keyframe then only starts the snapshot's host copy, the
        next keyframe starts the optimization from it, and with
        `pgba_background` that runs on a thread whose result a later
        keyframe adopts (the reference's RealtimePGBAState)."""
        if self.phase != ACTIVE or self.states is None:
            return False
        if self.calib.transition_model == 5:
            return False       # coarse IMU init only: never run PGBA
        bg = self._pgba_bg
        if bg is not None:
            # Harvest a finished background optimization first.
            if bg["thread"].is_alive():
                return False        # still optimizing; keep collecting KFs
            self._pgba_bg = None
            res = bg["result"][0]
            if res is not None:
                self.last_pgba_svar = float(res.s_var)
            if res is not None and res.ok:
                return self._adopt_pgba(res, frames_dev, slot_fids)
            self._retry_pgba_soon()
            return False
        pending = self._pgba_pending
        if pending is not None:
            # The trigger keyframe's snapshot copy has landed meanwhile.
            self._pgba_pending = None
            with TimeMeasurement("pgba_snapshot"):
                win_pack, ev_pack, st_np = pending["future"].result()
                win = self.build_kf_snapshot(win_pack, pending["slot_fids"])
                active_event = (pending["ev_build"](ev_pack)
                                if pending["ev_build"] else None)
            return self._start_pgba(win, active_event, st_np, frames_dev,
                                    slot_fids)
        self.kf_since_pgba += 1
        if every is None:
            every = self.calib.pgba_every
        # Denser early: the first two cycles fire at half cadence so short
        # sequences still get several adoption chances.
        gate = max(2, every // 2) if self.pgba_count < 2 else every
        if self.kf_since_pgba < gate or len(self.delayed_log.events) < 4:
            return False
        self.kf_since_pgba = 0
        self.pgba_count += 1
        st = self.states
        ev_disp = active_event_fn() if active_event_fn is not None else None
        refs = ((frames_dev.R_cw, frames_dev.t_cw, frames_dev.aff,
                 st.v, st.bg, st.ba),
                ev_disp[0] if ev_disp else None, (st.s_log, st.g2))
        if submit_fn is not None:
            self._pgba_pending = dict(
                future=submit_fn(refs), slot_fids=list(slot_fids),
                ev_build=ev_disp[1] if ev_disp else None)
            return False
        with TimeMeasurement("pgba_snapshot"):
            win_pack, ev_pack, st_np = to_host(refs)
            win = self.build_kf_snapshot(win_pack, slot_fids)
            active_event = ev_disp[1](ev_pack) if ev_disp else None
        return self._start_pgba(win, active_event, st_np, frames_dev,
                                slot_fids)

    def _retry_pgba_soon(self) -> None:
        """A failed run must not consume the whole cadence slot (short
        sequences get few): retry in 2 keyframes."""
        self.kf_since_pgba = max(
            self.kf_since_pgba, max(2, self.calib.pgba_every // 2) - 2)

    def _start_pgba(self, win, active_event, st_np, frames_dev,
                    slot_fids) -> bool:
        """Run PGBA on host snapshots: here, or on a background thread
        that touches no tensor (a copy of the delayed log, the window's
        host KFStates, the host active event and scale/gravity)."""
        if self.pgba_background:
            log_copy = self.delayed_log.snapshot()
            holder = [None]
            max_kfs = self.calib.pgba_max_kfs

            def work():
                with TimeMeasurement("pgba_thread"):
                    holder[0] = pgba.run(log_copy, win, active_event,
                                         float(st_np[0]),
                                         np.asarray(st_np[1]),
                                         max_kfs=max_kfs)

            th = threading.Thread(target=work, name="pgba", daemon=True)
            th.start()
            self._pgba_bg = {"thread": th, "result": holder}
            return False
        with TimeMeasurement("pgba"):
            res = pgba.run(self.delayed_log, win, active_event,
                           float(st_np[0]), np.asarray(st_np[1]),
                           max_kfs=self.calib.pgba_max_kfs)
        if res is not None:
            self.last_pgba_svar = float(res.s_var)
        if res is None or not res.ok:
            self._retry_pgba_soon()
            return False
        return self._adopt_pgba(res, frames_dev, slot_fids)

    def _adopt_pgba(self, res, frames_dev, slot_fids) -> bool:
        """Gate + take over a PGBA result (scale, gravity, velocities,
        biases + marginalization replacement per the transition model)."""
        if not (res.s_var < 0.05 * self.calib.pgba_scale_th
                and res.s_var < self.best_pgba_var * 0.9):
            return False
        self.best_pgba_var = res.s_var
        self.pgba_adopt_count += 1
        stx = self.states
        with TimeMeasurement("pgba_adopt_fetch"):
            v, bg, ba_, frames0_np = to_host(
                (stx.v, stx.bg, stx.ba,
                 (frames_dev.R0_cw, frames_dev.t0_cw, frames_dev.aff0)))
        v, bg, ba_ = np.array(v), np.array(bg), np.array(ba_)
        for slot, fid in enumerate(slot_fids):
            if fid is not None and fid in res.states:
                v[slot] = res.states[fid].v
                bg[slot] = res.states[fid].bg
                ba_[slot] = res.states[fid].ba

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)
        self.states = stx._replace(
            s_log=t(res.s_log), s_log0=t(res.s_log), g2=t(res.g2),
            g20=t(res.g2), v=t(v), v0=t(v), bg=t(bg), bg0=t(bg), ba=t(ba_),
            ba0=t(ba_))
        self.s_log = float(res.s_log)
        self.g2 = np.asarray(res.g2)
        # Marginalization replacement: model 1 never replaces; model 4
        # skips the first (initial) replacement only.
        first = not self._pgba_adopted_once
        self._pgba_adopted_once = True
        tm = self.calib.transition_model
        if tm != 1 and not (tm == 4 and first):
            target = self.build_kf_snapshot(
                (frames0_np[0], frames0_np[1], frames0_np[2], v, bg, ba_),
                list(slot_fids))
            with TimeMeasurement("pgba_adopt_rebuild"):
                self.replace_prior_from_log(slot_fids, res, target)
        return True

    def reinit_coarse_from_ba(self, R_cw, t_cw, slot: int,
                              st_np=None) -> None:
        """BA -> coarse handoff after each keyframe optimization
        (finishKeyframeOptimization, BAIMULogic.cpp:641). st_np: states
        already fetched by the caller (None after a PGBA adoption, which
        replaces the device states)."""
        if self.phase != ACTIVE or self.states is None:
            return
        st = st_np if st_np is not None else to_host(self.states)
        bias = np.concatenate([st.bg[slot], st.ba[slot]])
        self.coarse = vio_coarse.init_from_ba(
            np.asarray(R_cw), np.asarray(t_cw), st.v[slot], bias,
            float(st.s_log), np.asarray(st.g2))
        self.s_log = float(st.s_log)
        self.g2 = np.asarray(st.g2)
        self._maybe_fix_scale(st)

    def _maybe_fix_scale(self, st) -> None:
        if self.scale_fixed:
            return
        self._s_hist = (self._s_hist + [float(np.exp(st.s_log))])[
            -self.SCALE_FIX_WINDOW:]
        if len(self._s_hist) < self.SCALE_FIX_WINDOW:
            return
        lo, hi = min(self._s_hist), max(self._s_hist)
        if hi / max(lo, 1e-9) < self.SCALE_FIX_TH:
            self.scale_fixed = True
            # Move the scale/gravity FEJ to the converged value and pin it.
            sdev = self.states
            self.states = sdev._replace(s_log0=sdev.s_log, g20=sdev.g2)
            pr = np.array(self.prior_diag)
            Cg = ba_solve.cdim(self.f_max) + 9 * self.f_max
            pr[Cg:Cg + 3] = 1e8
            self.prior_diag = pr
