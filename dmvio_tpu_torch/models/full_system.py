"""Visual(-inertial) odometry pipeline orchestrator.

Counterpart of dmvio_tpu/models/full_system.py (FullSystem::addActiveFrame
/ trackNewCoarse / makeKeyFrame / initializeFromInitializer /
activatePointsMT / traceNewCoarse / flagFramesForMarginalization, and the
IMUIntegration seams). Serial mode processes each frame to completion:

  per frame:     pyramid -> initializer (until initialized) -> coarse
                 tracking of the 4-candidate ladder (with an IMU: the
                 coarse filter's prediction in the pad slot and its 17-dof
                 prior in the joint solve; 32-candidate rescue batch when
                 all fail) -> epipolar trace of the pool -> IMU init window
                 or coarse-filter fusion;
  per keyframe:  insert -> activate points (kernel K1) -> windowed BA
                 (visual, or joint visual-inertial once the IMU is ACTIVE;
                 kernel K1 in every linearization) -> fused marginalization
                 tail (K1 again) + host float64 prior algebra and the
                 delayed log -> tracker reference -> spawn new immature
                 points -> coarse IMU init / PGBA cycle.

Realtime mode (Config.realtime, the reference's pipelined mode) dispatches
each frame's tracking and trace at once and consumes its results when
their host copy (utils/fetch.py) has landed, frames later; keyframes are
decided at dispatch time and built from the deciding frame's own device
tensors, and the keyframe's host half (prior algebra, delayed log, IMU
init machine, PGBA, coarse-filter reseed) runs deferred, at the next
finalize; PGBA runs on a background thread. The same K1 kernel runs in the
keyframe's activation, BA and tail, visual and inertial.

Observers (io/output_wrapper.Output3DWrapper, the reference's observer
chain) attached to `output_wrappers` receive every tracked pose, the system
status, reset notices and, per keyframe, the window's poses, its
connectivity, the energy threshold and the metric transform; the newest
keyframe's depth map and inertial state only when a wrapper asks for them
(wants_depth_images, wants_imu_state), in one host copy. With no wrapper
attached the chain costs nothing on the device and no host sync.

save_checkpoint / load_checkpoint serialize the whole odometry state
(utils/checkpoint.py).

Not ported: multi-device BA (mesh_devices > 1 raises NotImplementedError).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dmvio_tpu_torch import device as resolve_device
from dmvio_tpu_torch.io import output_wrapper as ow
from dmvio_tpu_torch.models import ba, coarse_tracker, delayed, imu_system
from dmvio_tpu_torch.models import initializer, vio_ba, vio_coarse, window
from dmvio_tpu_torch.models import window_ops
from dmvio_tpu_torch.ops import ba_solve, immature, pyramid
from dmvio_tpu_torch.utils import fetch, lie
from dmvio_tpu_torch.utils.camera import Calib
from dmvio_tpu_torch.utils.timing import TimeMeasurement


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _fetch_flat(tensors) -> List[np.ndarray]:
    """Copy several small device tensors to the host in ONE transfer (cast
    to float32, concatenated, split again); bool masks come back as 0/1."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in tensors])
    host = _np(flat)
    out, k = [], 0
    for x in tensors:
        n = x.numel()
        out.append(host[k:k + n].reshape(tuple(x.shape)))
        k += n
    return out


def _guard_kf_pose(anyv, R, t, aff, R_fb, t_fb, aff_fb):
    """Select on the device between a solved pose and a fallback by the
    packed any-valid flag, which the host has not seen at dispatch time.
    It guards a dispatch-time keyframe's pose (fallback: the newest valid
    pose) and carries that newest valid pose from frame to frame (the
    reference's _guard_kf_pose and _carry_valid_pose, the same selection):
    a diverged solve must never seed the window."""
    ok = anyv > 0.5
    return (torch.where(ok, R, R_fb), torch.where(ok, t, t_fb),
            torch.where(ok, aff, aff_fb))


class FullSystem:
    """Monocular visual(-inertial) odometry.

    Pass `imu_calib` (imu_system.IMUCalib) to enable the inertial stack:
    IMU-aided coarse tracking, coarse IMU init, joint visual-inertial BA,
    delayed marginalization and PGBA. device=None means "cuda" and raises
    when CUDA is absent; pass device="cpu" to run on the CPU. `calib` is
    moved to that device."""

    def __init__(self, calib: Calib, h: int, w: int,
                 cfg: Optional[window.Config] = None, device=None,
                 imu_calib=None):
        self.device = resolve_device(device)
        self.cfg = cfg or window.Config()
        if self.cfg.mesh_devices and self.cfg.mesh_devices > 1:
            raise NotImplementedError(
                "dmvio_tpu_torch runs on one device; mesh_devices > 1 is not "
                "ported yet")
        # Cap pyramid depth so the coarsest level keeps enough pixels.
        while self.cfg.levels > 1 and \
                (min(h, w) >> (self.cfg.levels - 1)) < 12:
            self.cfg.levels -= 1
        self.imu = (imu_system.IMUSystem(imu_calib, self.cfg.f_max,
                                          self.device)
                    if imu_calib is not None else None)
        if self.imu is not None:
            # Realtime mode runs PGBA on a background thread (the
            # reference's RealtimePGBAState); serial mode stays
            # deterministic.
            self.imu.pgba_background = bool(self.cfg.realtime)
        calib = calib.to(self.device)
        self.calib = calib
        self.h, self.w = h, w
        self.win = window.Window(calib, h, w, self.cfg)
        self.imm = immature.empty_pool(self.cfg.i_max, self.device)
        self.init = initializer.VisualInitializer(
            calib, h, w, n_points=min(1024, self.cfg.p_max),
            levels=self.cfg.levels)
        self.initialized = False
        self.is_lost = False
        self.frame_id = 0
        self.first_id = 0
        self.shells: List[window.FrameShell] = []
        self.kf_poses = {}          # frame_id -> (R_cw, t_cw) numpy
        self.tracker_ref = None
        self.ref_kf_slot = -1
        self.ref_kf_id = -1
        self.ref_pose_np = (np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32))
        self.ref_aff_np = np.zeros(2, np.float32)
        self.T_last_ref = (np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
        self.motion = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.last_rho = 0.0
        self.last_b = 0.0
        self.track_energy_ref = 1.0
        self._n_active = 0.0
        self.stats_kf = 0
        self.stats_lost_frames = 0
        self.stats_resets = 0
        self._consec_lost = 0
        self._last_exposure = None
        self._frame_th_dev = None
        self._frame_th_np = None
        self._kf_st_host = None   # VIO tail's fetched states (host)
        # Realtime pipeline state.
        self._rt_queue = []       # in-flight frames, oldest first
        self._kf_finalize = None  # deferred keyframe host half
        self._fetcher = fetch.AsyncFetcher(enabled=self.cfg.async_fetch)
        self._last_pose_dev = None   # device pose history for candidates
        self._prev_pose_dev = None
        self._valid_pose_dev = None  # newest valid pose (keyframe guard)
        self._rt_chunks_since_kf = None  # replay buffer (deferred VIO KF)
        # Dispatch-time keyframe decisions: the newest landed score of the
        # current reference epoch (fid, score) and an EMA of its growth
        # per frame, which persists across epochs.
        self._kf_score_meas = None
        self._kf_score_rate = 0.0
        self._kf_epoch_fid = -1
        # Frame id the coarse IMU belief sits at; a dispatch-time keyframe
        # can move it ahead of the consume position.
        self._belief_fid = -1
        # Observer chain (Output3DWrapper.h:144) and the device tensors of
        # the newest tracker reference's depth map, copied only for a
        # wrapper that wants depth images.
        self.output_wrappers = []
        self._published_status = -1
        self._ref_depth_dev = None

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def add_frame(self, img, timestamp: float, imu_data=None,
                  exposure: float = 1.0) -> None:
        """Feed one photometrically corrected [H, W] image (a tensor or a
        numpy array; moved to the system's device). imu_data: optional
        (acc [N, 3], gyr [N, 3], dts [N]) measurements since the previous
        frame; ignored without an IMU."""
        img = self._t(img)
        fid = self.frame_id
        self.frame_id += 1
        e_exp = max(float(exposure), 1e-6)
        if self._last_exposure is not None and e_exp != self._last_exposure:
            dlog = float(np.log(e_exp) - np.log(self._last_exposure))
            self.last_rho += dlog
            if not self.initialized:
                self.init.shift_rho(dlog)
        self._last_exposure = e_exp
        if self.imu is not None and imu_data is not None:
            self.imu.add_frame_imu(*imu_data, fid=fid)
        with TimeMeasurement("pyramid"):
            pyr = tuple(pyramid.build_pyramid(img, levels=self.cfg.levels))

        if fid == self.first_id:
            self.init.set_first(pyr)
            self._first_pyr = pyr
            self._first_ts = timestamp
            self.shells.append(window.FrameShell(
                frame_id=fid, timestamp=timestamp, ref_kf_id=fid,
                R_c_ref=np.eye(3), t_c_ref=np.zeros(3), is_kf=True))
            return

        if not self.initialized:
            with TimeMeasurement("initializer"):
                r = self.init.try_init(pyr)
            self.shells.append(window.FrameShell(
                frame_id=fid, timestamp=timestamp, ref_kf_id=self.first_id,
                R_c_ref=_np(self.init.last_R), t_c_ref=_np(self.init.last_t)))
            if r is not None:
                self._initialize(r, pyr, timestamp, fid)
            elif fid - self.first_id > 60:
                # Give up and restart from the current frame.
                self.first_id = fid
                self.init.set_first(pyr)
                self._first_pyr = pyr
                self._first_ts = timestamp
                self.shells[-1] = window.FrameShell(
                    frame_id=fid, timestamp=timestamp, ref_kf_id=fid,
                    R_c_ref=np.eye(3), t_c_ref=np.zeros(3), is_kf=True)
            return

        if self.cfg.realtime:
            self._rt_frame(pyr, timestamp, fid)
            return

        with TimeMeasurement("coarse_tracking"):
            res, pk, need_kf = self._track_frame(pyr)
        self.shells.append(window.FrameShell(
            frame_id=fid, timestamp=timestamp, ref_kf_id=self.ref_kf_id,
            R_c_ref=pk.R.copy(), t_c_ref=pk.t.copy()))
        R_cw, t_cw, aff_new = window_ops.compose_abs_pose(
            res.R, res.t, res.rho, res.b_aff, self.win.frames,
            self.ref_kf_slot)
        with TimeMeasurement("trace"):
            self._trace_pool(R_cw, t_cw, aff_new, pyr)
        if self.imu is not None:
            R_cw_np = pk.R @ self.ref_pose_np[0]
            t_cw_np = pk.R @ self.ref_pose_np[1] + pk.t
            if self.imu.phase == imu_system.ACTIVE:
                # Fold the visual evidence into the coarse belief and move
                # its centre to the tracked state (addVisualToCoarseGraph).
                self.imu.fuse_tracked(pk.H_vis, R_cw_np, t_cw_np, pk.v,
                                      pk.bias)
            else:
                self.imu.record_init_pose(fid, self.ref_kf_id, pk.R, pk.t,
                                          R_cw_np)
        if self.output_wrappers:
            self._publish_pose(fid, timestamp, pk.R @ self.ref_pose_np[0],
                               pk.R @ self.ref_pose_np[1] + pk.t)
        if need_kf and not self.is_lost:
            # Never build a keyframe from an untracked pose.
            with TimeMeasurement("keyframe_total"):
                self._make_keyframe(pyr, timestamp, fid, R_cw, t_cw, aff_new)

        # Algorithmic self-reset: a dead map or sustained loss.
        self._consec_lost = self._consec_lost + 1 if self.is_lost else 0
        map_dead = self.initialized and self._n_active < 25 \
            and self.stats_kf > 3
        if map_dead or self._consec_lost > 8:
            self._full_reset(pyr, timestamp, fid)

    # ------------------------------------------------------------------
    # Realtime (pipelined) mode: the reference's two-thread track/map
    # pipeline (FullSystem.cpp:1124-1320) as a software pipeline. Each
    # frame's tracking and trace are dispatched at once and its packed
    # stats are copied to the host asynchronously; the frame is consumed
    # (host bookkeeping, IMU filter, lost/reset logic) when the copy has
    # landed. Keyframes are decided at dispatch time; their device half
    # runs then, their host half at the next finalize.
    def _rt_frame(self, pyr, ts, fid) -> None:
        # Inertial dispatch-time state: the frame's own chunk and a preview
        # belief propagated through every chunk the belief has not seen.
        imu_chunk = prior = v_init = bias_init = pred_pose = preview = None
        if self.imu is not None:
            imu_chunk = self.imu.frame_chunk()
            # Only chunks ahead of the belief: after a dispatch-time
            # keyframe finalize it can sit past older unconsumed frames.
            pending = [q["imu_chunk"]["pre_np"] if q["imu_chunk"] else None
                       for q in self._rt_queue if q["fid"] > self._belief_fid]
            pending.append(imu_chunk["pre_np"] if imu_chunk else None)
            # Past ~0.6 s of IMU-only propagation the dead-reckoned prior
            # is worse than none: track visually until the belief catches
            # up (the reference's preview horizon cap).
            preview = (self.imu.predict_preview(pending)
                       if len(pending) <= 12 else None)
            if preview is not None and self._kf_finalize is not None \
                    and self._kf_finalize.get("ref_pose_approx") is None:
                # A deferred keyframe with no host-side reference pose: the
                # prior cannot be phrased against the new reference.
                preview = None
            if preview is not None:
                # While the deferred keyframe's optimized pose is in
                # flight, its tracked (or IMU-predicted) pose stands in.
                if self._kf_finalize is not None:
                    R_ref, t_ref = self._kf_finalize["ref_pose_approx"]
                else:
                    R_ref, t_ref = self.ref_pose_np
                R_ref = np.asarray(R_ref, np.float64)
                t_ref = np.asarray(t_ref, np.float64)
                R_rel = preview.R_cw @ R_ref.T
                t_rel = preview.t_cw - R_rel @ t_ref
                pred_pose = (R_rel.astype(np.float32),
                             t_rel.astype(np.float32))
                prior = vio_coarse.make_tracker_prior(
                    preview, R_ref, t_ref, float(self.last_rho),
                    float(self.last_b), self.device)
                v_init = self._t(preview.v)
                bias_init = self._t(preview.bias)
        if self._last_pose_dev is not None \
                and self._prev_pose_dev is not None:
            # Candidates from the device pose history: dispatch never waits
            # on a pose copy.
            R_c, t_c, mask_c = window_ops.track_candidates(
                *self._last_pose_dev, *self._prev_pose_dev,
                self.win.frames, self.ref_kf_slot)
            if pred_pose is not None:
                # The IMU prediction takes the pad slot of the [4] batch.
                R_c = torch.cat([R_c[:3], self._t(pred_pose[0])[None]])
                t_c = torch.cat([t_c[:3], self._t(pred_pose[1])[None]])
                mask_c = torch.ones_like(mask_c)
        else:
            # Cold start (right after init or reset): host caches are fresh.
            self._finalize_kf()
            mR, mt = self.motion
            lR, lt = self.T_last_ref
            R_c = np.zeros((4, 3, 3), np.float32)
            t_c = np.zeros((4, 3), np.float32)
            mask_c = np.zeros(4, bool)
            R_c[0] = np.eye(3)
            R_c[1] = mR @ lR
            t_c[1] = mR @ lt + mt
            R_c[2] = lR
            t_c[2] = lt
            R_c[3] = np.eye(3)
            mask_c[1:] = True
            if pred_pose is not None:
                R_c[0], t_c[0] = pred_pose
                mask_c[0] = True
        with TimeMeasurement("coarse_tracking"):
            res, packed = self._track_dispatch(
                pyr, R_c, t_c, mask_c, self.last_rho, self.last_b, prior,
                v_init, bias_init)
        R_cw, t_cw, aff_new = window_ops.compose_abs_pose(
            res.R, res.t, res.rho, res.b_aff, self.win.frames,
            self.ref_kf_slot)
        self._prev_pose_dev = self._last_pose_dev or (R_cw, t_cw)
        self._last_pose_dev = (R_cw, t_cw)
        if self._valid_pose_dev is None:
            f = self.win.frames
            s = self.ref_kf_slot
            self._valid_pose_dev = (f.R_cw[s], f.t_cw[s], f.aff[s])
        self._valid_pose_dev = _guard_kf_pose(packed[-1], R_cw, t_cw,
                                              aff_new, *self._valid_pose_dev)
        imm_before = self.imm     # pre-trace pool (tensors are never mutated)
        with TimeMeasurement("trace"):
            self._trace_pool(R_cw, t_cw, aff_new, pyr)
        self.shells.append(window.FrameShell(
            frame_id=fid, timestamp=ts, ref_kf_id=self.ref_kf_id,
            R_c_ref=np.eye(3), t_c_ref=np.zeros(3)))
        self._rt_queue.append(dict(
            fid=fid, ts=ts, pyr=pyr, packed=packed,
            ref_kf_id=self.ref_kf_id,
            # Tracked against a reference whose pose has not reached the
            # host: None, patched by the keyframe's finalize.
            ref_pose=(None if self._kf_finalize is not None
                      else self.ref_pose_np),
            shell_idx=len(self.shells) - 1,
            R_cw=R_cw, t_cw=t_cw, aff=aff_new, imm_before=imm_before,
            imu_chunk=imu_chunk, had_prior=prior is not None,
            future=self._fetcher.submit(packed)))
        if self.cfg.rt_dispatch_kf:
            self._dispatch_kf_maybe(fid, preview)
        self._rt_drain(keep_last=True)

    def _rt_drain(self, keep_last: bool) -> None:
        """Consume in-flight frames whose host copies have landed, oldest
        first. Blocks on a copy only beyond rt_stall_depth in-flight frames
        or on a full flush; keep_last leaves the newest frame in flight."""
        keep = 1 if keep_last else 0
        cap = max(self.cfg.rt_stall_depth, keep) if keep_last else 0
        while len(self._rt_queue) > keep:
            p = self._rt_queue[0]
            if len(self._rt_queue) <= cap and not p["future"].done():
                break
            if p["ref_pose"] is None and len(self._rt_queue) <= cap \
                    and self._kf_finalize is not None \
                    and not self._kf_finalize["future"].done():
                # The frame needs the deferred keyframe's host half, whose
                # copy is still in flight: defer rather than block.
                break
            with TimeMeasurement("track_fetch"):
                arr = p["future"].result()
            if p["ref_pose"] is None:
                # Finalize the deferred keyframe first; its patch loop must
                # see this entry, so pop only afterwards.
                self._finalize_kf()
                if not self._rt_queue or self._rt_queue[0] is not p:
                    # The finalize found a failed init and reset the map;
                    # this frame and the rest of the queue died with it.
                    continue
            self._rt_queue.pop(0)
            self._rt_consume(p, arr)

    # -- dispatch-time keyframe decisions (Config.rt_dispatch_kf) --------
    def _kf_score_of(self, flow_t: float, flow_rt: float,
                     rho: float) -> float:
        """Dispatch-decision keyframe score, the reference's: the square
        root of the tracker's flow stats, scaled by rt_kf_density. The
        reference means the RMS-flow form (FullSystem.cpp:1052-1054), linear
        in the baseline as its rate extrapolation assumes; but the stats
        are RMS already, so this grows with the square root of the baseline
        (ROADMAP.md queue 3). The serial path keeps its own crossing in
        _track_frame."""
        cfg = self.cfg
        return cfg.kf_weight * cfg.rt_kf_density * (
            cfg.w_flow_t * np.sqrt(max(flow_t, 0.0)) / (self.w + self.h)
            + cfg.w_flow_rt * np.sqrt(max(flow_rt, 0.0)) / (self.w + self.h)
            + cfg.w_aff * abs(rho))

    def _peek_landed_scores(self) -> None:
        """Feed the score state from in-flight frames whose copies have
        landed, without consuming them. With async_fetch=False every copy
        lands at submit, so every frame's score is seen in order and the
        decision is deterministic."""
        for p in self._rt_queue:
            if p.get("score_noted") or not p["future"].done():
                continue
            self._note_score(p, coarse_tracker.PackedTrack(
                p["future"].result(), self.cfg.levels))

    def _note_score(self, p, pk) -> None:
        """Update the score state from one frame's stats (from the peek,
        or from consume for a frame whose copy landed late)."""
        if p.get("score_noted"):
            return
        p["score_noted"] = True
        if not pk.any_valid or p["ref_kf_id"] != self.ref_kf_id:
            return              # measured against a replaced reference
        score = self._kf_score_of(pk.flow_t, pk.flow_rt, pk.rho)
        # Rate from the absolute growth since the reference switch (the
        # score is ~0 there); the first observation seeds the EMA.
        d_epoch = p["fid"] - self._kf_epoch_fid
        if d_epoch > 0:
            obs = score / d_epoch
            if self._kf_score_rate <= 0.0:
                self._kf_score_rate = obs
            else:
                self._kf_score_rate = 0.5 * self._kf_score_rate + 0.5 * obs
        prev = self._kf_score_meas
        if prev is None or p["fid"] > prev[0]:
            self._kf_score_meas = (p["fid"], score)

    def _dispatch_kf_maybe(self, fid: int, preview) -> None:
        """Decide at dispatch time whether the just-dispatched frame
        becomes a keyframe (the newest landed score extrapolated to it by
        the measured growth rate), and if so dispatch the keyframe's
        device half from its own device tensors. While the previous
        keyframe's host copy is in flight the decision waits up to
        rt_kf_wait, then stretches the interval, up to rt_kf_stretch."""
        if not self.initialized or self.is_lost:
            return
        self._peek_landed_scores()
        meas = self._kf_score_meas
        rate = self._kf_score_rate
        if meas is not None:
            pred = meas[1] + rate * (fid - meas[0])
        else:
            pred = rate * (fid - self._kf_epoch_fid)
        # The interval floor bounds a transiently over-estimated rate.
        if pred <= 1.0 or fid - self._kf_epoch_fid < 2:
            return
        kfp = self._kf_finalize
        if kfp is not None and not kfp["future"].done():
            waited = False
            if self.cfg.rt_kf_wait > 0:
                try:
                    with TimeMeasurement("kf_decision_wait"):
                        kfp["future"].exception(timeout=self.cfg.rt_kf_wait)
                    waited = True
                except TimeoutError:
                    pass
            if not waited:
                if pred <= self.cfg.rt_kf_stretch:
                    return      # stretch through the stall
                with TimeMeasurement("kf_stretch_block"):
                    kfp["future"].exception()
        p = self._rt_queue[-1]        # the frame just dispatched
        self._finalize_kf()
        if not self.initialized or not self._rt_queue \
                or self._rt_queue[-1] is not p:
            return              # the finalize reset the map
        # Tracking validity is unknown at dispatch: guard the keyframe pose
        # on the device with the newest valid pose as fallback.
        R_kf, t_kf, aff_kf = _guard_kf_pose(
            p["packed"][-1], p["R_cw"], p["t_cw"], p["aff"],
            *self._valid_pose_dev)
        with TimeMeasurement("keyframe_total"):
            if self.imu is not None:
                approx = pred_v = None
                if preview is not None:
                    approx = (np.asarray(preview.R_cw, np.float32),
                              np.asarray(preview.t_cw, np.float32))
                    pred_v = np.asarray(preview.v)
                self._make_keyframe_rt_vio(
                    p["pyr"], p["fid"], R_kf, t_kf, aff_kf,
                    shell_idx=p["shell_idx"], ref_pose_approx=approx,
                    pred_v_override=pred_v)
            else:
                self._make_keyframe_rt(p["pyr"], p["fid"], R_kf, t_kf,
                                       aff_kf, shell_idx=p["shell_idx"])

    def _rt_consume(self, p, packed_np) -> None:
        """Finish a pipelined frame from its fetched packed stats: rescue,
        shell, motion model, IMU filter, consume-time keyframe decision
        (rt_dispatch_kf=False), lost/reset logic."""
        pk = coarse_tracker.PackedTrack(packed_np, self.cfg.levels)
        if not pk.any_valid:
            # Rescue against the current reference, with consistent host
            # caches first.
            self._finalize_kf()
            res_r, pk_r = self._rescue_track(p["pyr"])
            if pk_r.any_valid:
                pk = pk_r
                p["ref_pose"] = self.ref_pose_np
                p["ref_kf_id"] = self.ref_kf_id
                p["R_cw"], p["t_cw"], p["aff"] = window_ops.compose_abs_pose(
                    res_r.R, res_r.t, res_r.rho, res_r.b_aff,
                    self.win.frames, self.ref_kf_slot)
                if p["had_prior"] and self.imu is not None:
                    # The prior solve failed where visual rescue succeeded:
                    # the belief is inconsistent; the next BA re-seeds it.
                    self.imu.coarse = None
                    p["had_prior"] = False
        if not pk.any_valid:
            # Lost: report the constant-velocity prediction.
            mR, mt = self.motion
            lR, lt = self.T_last_ref
            pk.R = (mR @ lR).astype(np.float32)
            pk.t = (mR @ lt + mt).astype(np.float32)
            pk.rho, pk.b_aff = self.last_rho, self.last_b
            p["ref_pose"] = self.ref_pose_np
            p["ref_kf_id"] = self.ref_kf_id
        R_old, t_old = p["ref_pose"]          # ref pose used at dispatch
        R_cw_np = pk.R @ R_old
        t_cw_np = pk.R @ t_old + pk.t
        self.shells[p["shell_idx"]] = window.FrameShell(
            frame_id=p["fid"], timestamp=p["ts"], ref_kf_id=p["ref_kf_id"],
            R_c_ref=pk.R.copy(), t_c_ref=pk.t.copy(),
            is_kf=self.shells[p["shell_idx"]].is_kf)
        if pk.any_valid:
            self.is_lost = False
            self.track_energy_ref = min(
                0.7 * self.track_energy_ref + 0.3 * float(pk.level_energy[0]),
                self.cfg.track_gate_cap)
            # Motion model relative to the current reference.
            R_cur, t_cur = self.ref_pose_np
            R_rel = (R_cw_np @ R_cur.T).astype(np.float32)
            t_rel = (t_cw_np - R_rel @ t_cur).astype(np.float32)
            lR, lt = self.T_last_ref
            self.motion = (R_rel @ lR.T, t_rel - R_rel @ lR.T @ lt)
            self.T_last_ref = (R_rel, t_rel)
            self.last_rho = pk.rho
            self.last_b = pk.b_aff
        else:
            self.is_lost = True
            self.stats_lost_frames += 1

        if self.imu is not None:
            # Advance the belief through this frame's own chunk (the serial
            # predict-before-track, replayed at consume), then fold in the
            # visual evidence as the serial path does.
            chunk = p["imu_chunk"]
            advanced = chunk is not None and p["fid"] > self._belief_fid
            if advanced:
                self.imu.predict_coarse(chunk["pre_np"])
                self._belief_fid = p["fid"]
                if self._kf_finalize is not None \
                        and self._rt_chunks_since_kf is not None \
                        and p["fid"] > self._kf_finalize["fid"]:
                    # Replayed after the deferred keyframe's reseed.
                    self._rt_chunks_since_kf.append(
                        (p["fid"], chunk["pre_np"]))
            if pk.any_valid:
                if self.imu.phase == imu_system.ACTIVE:
                    # Fuse only when the belief sits at this frame.
                    if p["had_prior"] and advanced:
                        self.imu.fuse_tracked(pk.H_vis, R_cw_np, t_cw_np,
                                              pk.v, pk.bias)
                elif chunk is not None:
                    self.imu.record_init_pose(p["fid"], p["ref_kf_id"],
                                              pk.R, pk.t, R_cw_np,
                                              chunk=chunk)

        if self.output_wrappers:
            self._publish_pose(p["fid"], p["ts"], R_cw_np, t_cw_np)
        self._note_score(p, pk)
        score = self._kf_score_of(pk.flow_t, pk.flow_rt, pk.rho)
        if score > 1.0 and not self.is_lost \
                and not self.cfg.rt_dispatch_kf:
            # Consume-time keyframe: finish a previous one first; re-track
            # only the newest rt_redispatch_max in-flight frames against
            # the new reference, rewinding the pool to just before the
            # first of them was traced.
            self._finalize_kf()
            n_redispatch = min(len(self._rt_queue),
                               max(self.cfg.rt_redispatch_max, 0))
            redispatch = (self._rt_queue[-n_redispatch:]
                          if n_redispatch else [])
            if redispatch:
                self.imm = redispatch[0]["imm_before"]
            with TimeMeasurement("keyframe_total"):
                if self.imu is not None:
                    # The tracked (pre-BA) pose stands in as the host
                    # reference pose until the optimized one lands.
                    self._make_keyframe_rt_vio(
                        p["pyr"], p["fid"], p["R_cw"], p["t_cw"], p["aff"],
                        shell_idx=p["shell_idx"],
                        ref_pose_approx=(R_cw_np.astype(np.float32),
                                         t_cw_np.astype(np.float32)))
                else:
                    self._make_keyframe_rt(p["pyr"], p["fid"], p["R_cw"],
                                           p["t_cw"], p["aff"],
                                           shell_idx=p["shell_idx"])
            for q in redispatch:
                # Identity check: the keyframe build may have reset the
                # queue.
                if any(q is x for x in self._rt_queue):
                    self._rt_redispatch(q)
        self._consec_lost = self._consec_lost + 1 if self.is_lost else 0
        map_dead = self.initialized and self._n_active < 25 \
            and self.stats_kf > 3
        if map_dead or self._consec_lost > 8:
            self._full_reset(p["pyr"], p["ts"], p["fid"])

    def _rt_redispatch(self, p) -> None:
        """Re-track an in-flight frame against the just-switched reference,
        with candidates computed on the device from its own pose (the new
        reference's pose has not reached the host), replacing its pending
        results."""
        R_c, t_c, mask_c = window_ops.rel_candidates(
            p["R_cw"], p["t_cw"], self.win.frames, self.ref_kf_slot)
        res, packed = self._track_dispatch(p["pyr"], R_c, t_c, mask_c, 0.0,
                                           0.0)
        R_cw, t_cw, aff_new = window_ops.compose_abs_pose(
            res.R, res.t, res.rho, res.b_aff, self.win.frames,
            self.ref_kf_slot)
        p.update(packed=packed, ref_kf_id=self.ref_kf_id,
                 ref_pose=(None if self._kf_finalize is not None
                           else self.ref_pose_np),
                 R_cw=R_cw, t_cw=t_cw, aff=aff_new, imm_before=self.imm,
                 # The replacement solve carried no IMU prior.
                 had_prior=False,
                 future=self._fetcher.submit(packed))
        if self._rt_queue and p is self._rt_queue[-1]:
            self._last_pose_dev = (R_cw, t_cw)
        self._trace_pool(R_cw, t_cw, aff_new, p["pyr"])

    def finish(self) -> None:
        """Flush the realtime pipeline: finalize the deferred keyframe,
        consume every in-flight frame, and finalize again if consuming
        made another keyframe. Nothing is in flight in serial mode."""
        self._finalize_kf()
        while self._rt_queue:
            self._rt_drain(keep_last=False)
            self._finalize_kf()

    # ------------------------------------------------------------------
    def _rescue_candidates(self):
        """32-candidate rescue batch: motion variants + 26 rotation-
        perturbed constant-motion initializations (FullSystem.cpp:369-399)."""
        mR, mt = self.motion
        lR, lt = self.T_last_ref
        cv_R, cv_t = mR @ lR, mR @ lt + mt
        w_half = lie.log_so3_np(np.asarray(mR, np.float64)) * 0.5
        R_half = lie.exp_so3_np(w_half).astype(np.float32)
        cands = [
            (cv_R, cv_t),                                  # const motion
            (mR @ cv_R, mR @ cv_t + mt),                   # double motion
            (R_half @ lR, R_half @ lt + 0.5 * mt),         # half motion
            (lR, lt),                                      # zero motion
            (np.eye(3, dtype=np.float32),
             np.zeros(3, np.float32)),                     # zero from KF
        ]
        delta = 0.04
        for sx in (-1, 0, 1):
            for sy in (-1, 0, 1):
                for sz in (-1, 0, 1):
                    if sx == sy == sz == 0:
                        continue
                    dR = lie.exp_so3_np(delta * np.array(
                        [sx, sy, sz], np.float64)).astype(np.float32)
                    cands.append((cv_R @ dR, cv_t))
        C = 32
        R_c = np.zeros((C, 3, 3), np.float32)
        t_c = np.zeros((C, 3), np.float32)
        mask_c = np.zeros(C, bool)
        for k, (R0, t0) in enumerate(cands[:C]):
            R_c[k] = R0
            t_c[k] = t0
            mask_c[k] = True
        return R_c, t_c, mask_c

    def _track_dispatch(self, pyr, R_c, t_c, mask_c, rho, b, prior=None,
                        v_init=None, bias_init=None):
        """Track the candidate batch against the tracker reference; the
        result and the packed stats stay on the device."""
        gate = (self.cfg.track_gate_scale * self.track_energy_ref
                + self.cfg.track_gate_offset)
        return coarse_tracker.track_multi(
            self.tracker_ref, pyr, self.calib, self._t(R_c), self._t(t_c),
            self._t(mask_c, torch.bool), self._t(rho), self._t(b),
            self._t(gate), levels=self.cfg.levels, prior=prior,
            v_init=v_init, bias_init=bias_init)

    def _track_multi(self, pyr, R_c, t_c, mask_c, prior=None, v_init=None,
                     bias_init=None):
        res, packed = self._track_dispatch(pyr, R_c, t_c, mask_c,
                                           self.last_rho, self.last_b, prior,
                                           v_init, bias_init)
        # ONE small fetch carries every stat the host needs.
        return res, coarse_tracker.PackedTrack(_np(packed), self.cfg.levels)

    def _rescue_track(self, pyr):
        """Last-resort tracking with the big perturbation batch."""
        return self._track_multi(pyr, *self._rescue_candidates())

    def _track_frame(self, pyr):
        """Coarse tracking of the candidate ladder [IMU prediction or
        unused pad, constant velocity, zero motion, identity] with
        on-device selection; with an ACTIVE IMU every candidate runs the
        joint solve under the coarse filter's prior, and a failed prior
        solve falls back to visual-only tracking."""
        mR, mt = self.motion
        lR, lt = self.T_last_ref
        R_c = np.zeros((4, 3, 3), np.float32)
        t_c = np.zeros((4, 3), np.float32)
        mask_c = np.zeros(4, bool)
        R_c[0] = np.eye(3)
        R_c[1] = mR @ lR
        t_c[1] = mR @ lt + mt
        R_c[2] = lR
        t_c[2] = lt
        R_c[3] = np.eye(3)
        mask_c[1:] = True
        prior = v_init = bias_init = None
        if self.imu is not None:
            pred = self.imu.predict_coarse()
            if pred is not None:
                # The IMU prediction takes the pad slot of the [4] batch.
                R_ref, t_ref = self.ref_pose_np
                R_rel = pred.R_cw @ np.asarray(R_ref, np.float64).T
                t_rel = pred.t_cw - R_rel @ np.asarray(t_ref, np.float64)
                R_c[0] = R_rel.astype(np.float32)
                t_c[0] = t_rel.astype(np.float32)
                mask_c[0] = True
                prior = self.imu.coarse_prior(R_ref, t_ref, self.last_rho,
                                              self.last_b)
                v_init = self._t(pred.v)
                bias_init = self._t(pred.bias)
        res, pk = self._track_multi(pyr, R_c, t_c, mask_c, prior, v_init,
                                    bias_init)
        if not pk.any_valid and prior is not None:
            # The prior solve failed on every candidate: the coarse belief
            # is likely inconsistent. Track visually and let the next BA
            # re-seed the belief (FullSystem.cpp:440-445).
            res2, pk2 = self._track_multi(pyr, R_c, t_c, mask_c)
            if pk2.any_valid:
                res, pk = res2, pk2
                self.imu.coarse = None
        if not pk.any_valid:
            res3, pk3 = self._rescue_track(pyr)
            if pk3.any_valid:
                res, pk = res3, pk3
                if self.imu is not None:
                    self.imu.coarse = None
        best = pk
        best_e = float(pk.level_energy[0])
        if not pk.any_valid:
            self.is_lost = True
            self.stats_lost_frames += 1
            # Report the constant-velocity prediction as this frame's pose.
            pk.R = (mR @ lR).astype(np.float32)
            pk.t = (mR @ lt + mt).astype(np.float32)
            pk.rho, pk.b_aff = self.last_rho, self.last_b
        else:
            self.is_lost = False
            self.track_energy_ref = min(
                0.7 * self.track_energy_ref + 0.3 * best_e,
                self.cfg.track_gate_cap)
            lR_new = best.R
            lt_new = best.t
            self.motion = (lR_new @ lR.T, lt_new - lR_new @ lR.T @ lt)
            self.T_last_ref = (lR_new, lt_new)
            self.last_rho = best.rho
            self.last_b = best.b_aff

        # Keyframe decision on host floats (FullSystem.cpp:1038-1100).
        cfg = self.cfg
        score = cfg.kf_weight * (
            cfg.w_flow_t * best.flow_t / (self.w + self.h)
            + cfg.w_flow_rt * best.flow_rt / (self.w + self.h)
            + cfg.w_aff * abs(best.rho))
        return res, best, score > 1.0

    def _trace_pool(self, R_cw, t_cw, aff_new, pyr):
        """Trace all immature points against the new frame."""
        f = self.win.frames
        host = self.imm.host.long()
        self.imm = immature.trace(self.imm, f.R_cw[host], f.t_cw[host],
                                  f.aff[host], R_cw, t_cw, aff_new, pyr[0],
                                  self.calib)

    # ------------------------------------------------------------------
    def _full_reset(self, pyr, timestamp, fid) -> None:
        """Rebuild the visual window from the current frame."""
        self.stats_resets += 1
        self._consec_lost = 0
        self._rt_queue = []       # in-flight frames belong to the dead map
        self._kf_finalize = None  # so does the deferred keyframe tail
        self._rt_chunks_since_kf = None
        self._last_pose_dev = None
        self._prev_pose_dev = None
        self._valid_pose_dev = None
        self._kf_score_meas = None
        self._kf_score_rate = 0.0
        self._kf_epoch_fid = fid
        self._belief_fid = -1
        self.win = window.Window(self.calib, self.h, self.w, self.cfg)
        self.imm = immature.empty_pool(self.cfg.i_max, self.device)
        self.initialized = False
        self.is_lost = False
        self.tracker_ref = None
        self.ref_kf_slot = -1
        self.ref_kf_id = -1
        self._n_active = 0.0
        self.track_energy_ref = 1.0
        self.T_last_ref = (np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
        self.motion = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.last_rho = 0.0
        self.last_b = 0.0
        self.first_id = fid
        self.init.set_first(pyr)
        self._first_pyr = pyr
        self._first_ts = timestamp
        for k in range(len(self.shells) - 1, -1, -1):
            # The reset frame is usually the newest shell, but in realtime
            # mode a younger in-flight frame may sit after it.
            if self.shells[k].frame_id == fid:
                self.shells[k] = window.FrameShell(
                    frame_id=fid, timestamp=timestamp, ref_kf_id=fid,
                    R_c_ref=np.eye(3), t_c_ref=np.zeros(3), is_kf=True)
                break
        if self.imu is not None:
            # Back to coarse-init collection; the bias and the last scale
            # estimate survive as the next init's warm start.
            imu = self.imu
            imu.phase = imu_system.COARSE_INIT
            imu.states = None
            imu.pairs = []
            imu._pending_pairs = []
            imu.coarse = None
            imu.clear_init_window()
            imu.kf_since_pgba = 0
        for w_ in self.output_wrappers:
            w_.reset()
            w_.publish_system_status(ow.RESETTING)
        self._published_status = ow.RESETTING

    def _initialize(self, r: initializer.InitResult, pyr, ts, fid):
        cfg = self.cfg
        w = self.win
        dev = self.device
        w.insert_frame(0, self.first_id, self._first_pyr,
                       torch.eye(3, device=dev), torch.zeros(3, device=dev),
                       torch.zeros(2, device=dev))
        w.set_frame_prior(0, cfg.first_pose_prior, cfg.first_aff_prior,
                          cfg.first_aff_prior)
        aff1 = torch.stack([r.rho, r.b_aff]).to(torch.float32)
        w.insert_frame(1, fid, pyr, r.R, r.t, aff1)
        w.set_frame_prior(1, 0.0, cfg.aff_a_prior, cfg.aff_b_prior)
        hosts = np.zeros(r.u.shape[0], np.int32)
        w.add_points(hosts, r.u, r.v, r.idepth, r.color, r.weight, r.mask)

        self._run_ba(max_iters=8)
        w.set_fej_to_current(0)
        w.set_fej_to_current(1)
        self._record_kf_poses()

        self.shells[-1] = window.FrameShell(
            frame_id=fid, timestamp=ts, ref_kf_id=fid,
            R_c_ref=np.eye(3), t_c_ref=np.zeros(3), is_kf=True)
        # Rescale the pre-init shells into the final map scale (host f64).
        t1_ba = self.kf_poses.get(fid, (None, None))[1]
        f_corr = float(r.scale)
        raw = float(np.linalg.norm(_np(r.t))) / max(f_corr, 1e-12)
        if t1_ba is not None and raw > 1e-9:
            f_corr = float(np.linalg.norm(t1_ba)) / raw
        for sh in self.shells:
            if self.first_id < sh.frame_id < fid \
                    and sh.ref_kf_id == self.first_id:
                sh.t_c_ref = sh.t_c_ref * f_corr
        self._set_tracker_ref(1, fid)
        self._spawn_immatures(1, pyr)
        self.initialized = True
        self.stats_kf = 2
        if self.imu is not None:
            # The visual init rescaled the world: restart the IMU-init pose
            # window from here.
            self.imu.clear_init_window()
            self.imu.phase = imu_system.COARSE_INIT

    # ------------------------------------------------------------------
    def _make_keyframe(self, pyr, ts, fid, R_cw, t_cw, aff_new):
        cfg = self.cfg
        w = self.win
        slot = w.free_frame_slot()
        prev_slot = self.ref_kf_slot
        w.insert_frame(slot, fid, pyr, R_cw, t_cw, aff_new)
        w.set_frame_prior(slot, 0.0, cfg.aff_a_prior, cfg.aff_b_prior)
        self.shells[-1].is_kf = True
        self.stats_kf += 1
        if self.imu is not None:
            pred_v = (np.asarray(self.imu.coarse.v)
                      if self.imu.coarse is not None else None)
            prev_fid = (w.slot_frame_id[prev_slot] if prev_slot >= 0
                        else None)
            self.imu.on_new_keyframe(prev_slot, slot, pred_v,
                                     fids=(prev_fid, fid))
        with TimeMeasurement("activate"):
            self._activate_points(slot)
        snap = (w.frames, w.points, w.pair_mask, w.calib,
                self.imu.states if self.imu is not None else None)
        with TimeMeasurement("ba_optimize"):
            ba_res = self._run_ba(max_iters=cfg.ba_iters)
        if self.stats_kf <= 4 and \
                self._init_failed(float(self._ba_rmse_dev(ba_res)),
                                  self.stats_kf):
            # Initialization failed (FullSystem.cpp:1417-1434).
            self._full_reset(pyr, ts, fid)
            return
        w.frames = window_ops.set_fej_current(w.frames, slot)
        self._imu_set_fej(slot)
        self._kf_st_host = None
        with TimeMeasurement("marg_tail"):
            if self._vio_mode():
                pose_pack_np = self._kf_fused_tail_vio(slot, snap)
            else:
                pose_pack_np = self._kf_fused_tail(slot, snap)
        pose_pack = self._record_kf_poses(pose_pack_np)
        with TimeMeasurement("tracker_ref"):
            self._set_tracker_ref(slot, fid, pose_pack)
        with TimeMeasurement("spawn_immatures"):
            self._spawn_immatures(slot, pyr)
        self._publish_keyframe_events()

        if self.imu is not None:
            if self.imu.phase == imu_system.COARSE_INIT:
                # postBAInit seam: run the coarse IMU init; take over when
                # the scale marginal is trustworthy.
                if self.imu.try_initialize(self.kf_poses):
                    self._imu_activate(slot)
            if self.imu.phase == imu_system.ACTIVE:
                adopted = self.imu.maybe_run_pgba(
                    w.frames, w.slot_frame_id,
                    active_event_fn=self._active_visual_event)
                F = cfg.f_max
                R_np = pose_pack[:9 * F].reshape(F, 3, 3)[slot]
                t_np = pose_pack[9 * F:12 * F].reshape(F, 3)[slot]
                self.imu.reinit_coarse_from_ba(
                    R_np, t_np, slot,
                    st_np=None if adopted else self._kf_st_host)
                self._kf_st_host = None

    def _imu_set_fej(self, slot: int) -> None:
        if self.imu is None or self.imu.states is None:
            return
        st = self.imu.states

        def put(a0, a):
            a0 = a0.clone()
            a0[slot] = a[slot]
            return a0
        self.imu.states = st._replace(v0=put(st.v0, st.v),
                                      bg0=put(st.bg0, st.bg),
                                      ba0=put(st.ba0, st.ba))

    def _imu_activate(self, newest_slot: int) -> None:
        """COARSE_INIT -> ACTIVE takeover (initFromIMUInit seam): build the
        VIO states around the current window and convert the visual
        marginalization prior into the extended units."""
        w = self.win
        imu = self.imu
        imu.activate(w.slot_frame_id, imu.init_velocity_of)
        Cv = ba_solve.cdim(self.cfg.f_max)
        C = vio_ba.cdim_ext(self.cfg.f_max)
        imu.HM = np.zeros((C, C), np.float64)
        imu.HM[:Cv, :Cv] = w.HM * vio_ba.W_DSO
        imu.bM0 = np.zeros((C,), np.float64)
        imu.bM0[:Cv] = w.bM0 * vio_ba.W_DSO
        # The activation prior seeds the delayed log so a marginalization
        # replacement can re-derive the full main prior later.
        imu.record_base_event(w.frames, w.slot_frame_id)
        imu.reinit_coarse_from_ba(_np(w.frames.R_cw[newest_slot]),
                                  _np(w.frames.t_cw[newest_slot]),
                                  newest_slot)

    def _vio_mode(self) -> bool:
        return (self.imu is not None
                and self.imu.phase == imu_system.ACTIVE
                and self.imu.states is not None)

    def _ext_prior_diag(self) -> torch.Tensor:
        """Extended prior diagonal: the visual priors in Mahalanobis units
        and the IMU-block priors."""
        Cv = ba_solve.cdim(self.cfg.f_max)
        return self._t(np.concatenate([
            np.asarray(self.win.prior_diag) * vio_ba.W_DSO,
            np.asarray(self.imu.prior_diag)[Cv:]]))

    def _vio_problem(self) -> vio_ba.VIOProblem:
        imu = self.imu
        return vio_ba.VIOProblem(
            base=self._problem(), states=imu.states,
            pairs=imu.device_pairs(), HM=self._t(imu.HM),
            bM0=self._t(imu.bM0), prior_diag=self._ext_prior_diag(),
            R_cb=imu.R_cb, t_cb=imu.t_cb, imu_on=True)

    def _problem(self) -> ba.BAProblem:
        w = self.win
        return ba.BAProblem(
            frames=w.frames, points=w.points, calib=w.calib,
            calib0=w.calib0, HM=self._t(w.HM), bM0=self._t(w.bM0),
            prior_diag=self._t(w.prior_diag), pair_mask=w.pair_mask)

    def _run_ba(self, max_iters: int):
        w = self.win
        if self._vio_mode():
            result = vio_ba.optimize(self._vio_problem(), w.images,
                                     max_iters=max_iters)
            self.imu.states = result.states
        else:
            result = ba.optimize(self._problem(), w.images,
                                 max_iters=max_iters)
        self._frame_th_dev = result.frame_th
        w.frames = result.frames
        w.points = result.points
        w.calib = result.calib
        self.calib = result.calib
        w.points, w.pair_mask = window_ops.post_ba_update(
            w.points, w.pair_mask, result.pair_outlier)
        return result

    def _ba_rmse_dev(self, result):
        """Photometric RMSE per pattern pixel of a BA result."""
        w = self.win
        pair_ok = w.pair_mask & w.points.mask[None, :] & ~result.pair_outlier
        n = torch.sum(pair_ok.to(torch.float32))
        return torch.sqrt(result.energy / torch.clamp(8.0 * n, min=1.0))

    @staticmethod
    def _init_failed(rmse: float, kf_count: int) -> bool:
        """Photometric RMSE thresholds on keyframes 2-4
        (FullSystem.cpp:1417-1434): the two-frame init handed over a bad
        map."""
        th = {2: 20.0, 3: 13.0, 4: 9.0}.get(kf_count)
        return th is not None and (not np.isfinite(rmse) or rmse > th)

    def _record_kf_poses(self, pack_np: Optional[np.ndarray] = None):
        """Record window poses into kf_poses from one packed fetch."""
        w = self.win
        F = self.cfg.f_max
        if pack_np is None:
            pack_np = _np(window_ops.kf_pose_pack(w.frames))
        R = pack_np[:9 * F].reshape(F, 3, 3)
        t = pack_np[9 * F:12 * F].reshape(F, 3)
        for s in range(F):
            fid = w.slot_frame_id[s]
            if fid is not None:
                self.kf_poses[fid] = (R[s].copy(), t[s].copy())
        return pack_np

    def _activate_points(self, new_slot: int):
        """Activate well-traced immatures with spatial spreading; the
        radius follows the density of the previous keyframe."""
        w = self.win
        ratio = self._n_active / max(self.cfg.p_max, 1)
        self.imm, w.points, w.pair_mask = window_ops.activate_and_admit(
            self.imm, w.frames, w.points, w.pair_mask, w.images, w.calib,
            new_slot, h=self.h, w=self.w,
            radius=0 if ratio < 0.8 else (1 if ratio < 1.0 else 2),
            use_spacing=ratio >= 0.5)

    def _kf_fused_tail(self, newest_slot: int, snap) -> np.ndarray:
        """Keyframe tail: victims + point-marg fold + drops on the device,
        one host read, then the host prior algebra. Returns the pose pack.
        A diverged BA (nearly every point dropped) is reverted once."""
        w = self.win

        def dispatch():
            vlist, HM, bM, pts, pm, n_pre, n_post = \
                self._dispatch_marg_fused(newest_slot)
            with TimeMeasurement("kf_sync_stats"):
                pose = window_ops.kf_pose_pack(w.frames)
                host = [_np(x) for x in (vlist, HM, bM, n_pre, n_post, pose,
                                         self._frame_th_dev)]
            return host[:-1], (pts, pm), host[-1]

        fetched, (pts_d, pm_d), self._frame_th_np = dispatch()
        vlist, HM_np, bM_np, n_pre, n_post, pose_pack_np = fetched
        if self._n_active > 60 and \
                float(n_pre) < max(40.0, 0.15 * self._n_active):
            w.frames, w.points, w.pair_mask, w.calib = snap[:4]
            self.calib = w.calib
            w.frames = window_ops.set_fej_current(w.frames, newest_slot)
            fetched, (pts_d, pm_d), self._frame_th_np = dispatch()
            vlist, HM_np, bM_np, n_pre, n_post, pose_pack_np = fetched
        self._n_active = float(n_post)
        self._apply_marg_host(vlist, HM_np, bM_np, pts_d, pm_d)
        return pose_pack_np

    def _dispatch_marg_fused(self, newest_slot: int):
        w = self.win
        cfg = self.cfg
        slots = w.slots_by_age()
        age_rank = np.full(cfg.f_max, -1, np.int32)
        for r_, s_ in enumerate(slots):
            age_rank[s_] = r_
        n_drop = max(0, len(slots) - cfg.max_frames) if len(slots) > 2 else 0
        return ba.marg_fused(self._problem(), w.images,
                             self._t(age_rank, torch.int32), n_drop,
                             newest_slot)

    def _apply_marg_host(self, vlist, HM_np, bM_np, pts_new_d,
                         pm_new_d) -> None:
        """Host side of the marginalization: float64 prior algebra,
        per-victim Schur, slot bookkeeping, immature/orphan pruning."""
        w = self.win
        Cv = ba_solve.cdim(self.cfg.f_max)
        with TimeMeasurement("marginalize"):
            w.points, w.pair_mask = pts_new_d, pm_new_d
            w.HM = w.HM + np.asarray(HM_np, np.float64)
            w.bM0 = w.bM0 + np.asarray(bM_np, np.float64)
            victims = [int(s_) for s_ in vlist if s_ >= 0]
            for s_ in victims:
                w.frame_prior_into_HM(s_)
                i0 = ba_solve.CPART + 8 * s_
                mmask = np.zeros(Cv, bool)
                mmask[i0:i0 + 8] = True
                w.HM, w.bM0 = ba_solve.schur_out_np(w.HM, w.bM0, mmask)
                w.frames, w.pair_mask = window_ops.drop_frame_slot(
                    w.frames, w.pair_mask, s_)
                w.pyramids[s_] = None
                w.slot_frame_id[s_] = None
            if victims:
                vl = self._t(np.asarray(vlist), torch.int64)
                is_victim = torch.any(
                    self.imm.host.long()[None, :] == vl[:, None], dim=0)
                self.imm = self.imm._replace(mask=self.imm.mask & ~is_victim)
                w.points, w.pair_mask = window_ops.post_ba_update(
                    w.points, w.pair_mask, torch.zeros_like(w.pair_mask))

    # ------------------------------------------------------------------
    def _dispatch_vio_tail(self, newest_slot: int):
        """Dispatch of the fused extended keyframe tail, with no host read:
        vio_ba.vio_marg_fused (victims, extended point-marg fold, pair
        fold, drops; K1 in its linearization) and the FEJ, state and pose
        tensors that ride its one host copy. Returns (refs to copy, points,
        pair_mask)."""
        w = self.win
        imu = self.imu
        slots = w.slots_by_age()
        age_rank = np.full(self.cfg.f_max, -1, np.int32)
        for r_, s_ in enumerate(slots):
            age_rank[s_] = r_
        n_drop = max(0, len(slots) - self.cfg.max_frames) \
            if len(slots) > 2 else 0
        (vlist, HM, bM, foldH, foldb, pts, pm, n_pre,
         n_post) = vio_ba.vio_marg_fused(
            self._vio_problem(), w.images, self._t(age_rank, torch.int32),
            n_drop, newest_slot)
        st = imu.states
        fej = (w.frames.R0_cw, w.frames.t0_cw, w.frames.aff0, st.v0, st.bg0,
               st.ba0, st.s_log0, st.g20)
        refs = (vlist, HM, bM, foldH, foldb, n_pre, n_post,
                window_ops.kf_pose_pack(w.frames), fej, st,
                self._frame_th_dev)
        return refs, pts, pm

    def _apply_vio_tail_host(self, fetched, pts_d, pm_d) -> np.ndarray:
        """Host half of the extended tail: float64 prior algebra, the
        delayed-log events, slot bookkeeping. Returns the pose pack."""
        w = self.win
        imu = self.imu
        (vlist, HM_np, bM_np, foldH, foldb, _, n_post, pose_pack_np,
         fej_np, self._kf_st_host, self._frame_th_np) = fetched
        self._n_active = float(n_post)
        victims = [int(s) for s in vlist if s >= 0]
        with TimeMeasurement("marginalize"):
            w.points, w.pair_mask = pts_d, pm_d
            HM_add = np.asarray(HM_np, np.float64)
            bM_add = np.asarray(bM_np, np.float64)
            imu.HM = imu.HM + HM_add
            imu.bM0 = imu.bM0 + bM_add
            if victims:
                self._vio_marginalize_frames(victims, (HM_add, bM_add),
                                             (foldH, foldb), fej_np)
                for s_ in victims:
                    w.pyramids[s_] = None
                    w.slot_frame_id[s_] = None
                vl = self._t(np.asarray(vlist), torch.int64)
                is_victim = torch.any(
                    self.imm.host.long()[None, :] == vl[:, None], dim=0)
                self.imm = self.imm._replace(mask=self.imm.mask & ~is_victim)
            w.points, w.pair_mask = window_ops.post_ba_update(
                w.points, w.pair_mask, torch.zeros_like(w.pair_mask))
        return pose_pack_np

    def _kf_fused_tail_vio(self, newest_slot: int, snap) -> np.ndarray:
        """Extended (visual-inertial) keyframe tail: the device dispatch,
        one host read, then the host half. Returns the pose pack. A
        diverged BA (nearly every point dropped) is reverted once."""
        w = self.win
        imu = self.imu

        def dispatch():
            refs, pts, pm = self._dispatch_vio_tail(newest_slot)
            with TimeMeasurement("kf_sync_stats"):
                fetched = fetch.to_host(refs)
            return fetched, pts, pm

        fetched, pts_d, pm_d = dispatch()
        if self._n_active > 60 and \
                float(fetched[5]) < max(40.0, 0.15 * self._n_active):
            w.frames, w.points, w.pair_mask, w.calib = snap[:4]
            if snap[4] is not None:
                imu.states = snap[4]
            self.calib = w.calib
            w.frames = window_ops.set_fej_current(w.frames, newest_slot)
            fetched, pts_d, pm_d = dispatch()
        return self._apply_vio_tail_host(fetched, pts_d, pm_d)

    def _vio_marginalize_frames(self, victims, event_quad, fold_np,
                                fej_np) -> None:
        """Extended-state frame marginalization: fold the victims' IMU pair
        factors into the prior, log the delayed-marginalization events,
        then Schur out 8 + 9 coordinates per victim (marginalizeBAFrame).
        event_quad: the point-marginalization quadratic this event absorbs;
        fold_np: the victims' pair-factor quadratic; fej_np: the fetched
        FEJ snapshot (R0, t0, aff0, v0, bg0, ba0, s_log0, g20)."""
        w = self.win
        imu = self.imu
        F = self.cfg.f_max
        C_ext = vio_ba.cdim_ext(F)
        # Snapshot what this event absorbs BEFORE any state is dropped.
        ev_slots = w.slots_by_age()
        ev_slot_fids = list(w.slot_frame_id)
        H_ev = event_quad[0].copy()
        b_ev = event_quad[1]
        # Fold the victims' diagonal priors into the event quadratic too.
        pr_vis0 = np.array(w.prior_diag)
        pr_imu0 = np.array(imu.prior_diag)
        for s_ in victims:
            i0 = ba_solve.CPART + 8 * s_
            j0 = vio_ba.imu_offset(F, s_)
            H_ev[np.arange(i0, i0 + 8), np.arange(i0, i0 + 8)] += \
                pr_vis0[i0:i0 + 8] * vio_ba.W_DSO
            H_ev[np.arange(j0, j0 + 9), np.arange(j0, j0 + 9)] += \
                pr_imu0[j0:j0 + 9]
        # 1) IMU pair factors touching victims -> prior (FEJ + r0).
        imu.HM = imu.HM + np.asarray(fold_np[0], np.float64)
        imu.bM0 = imu.bM0 + np.asarray(fold_np[1], np.float64)
        removed_pairs = imu.drop_pairs_touching(list(victims))
        slot_fid_map = {sl: ev_slot_fids[sl] for sl in range(F)}
        fej_snap = imu.build_kf_snapshot(fej_np[:6], ev_slot_fids)
        st0 = (float(fej_np[6]), np.asarray(fej_np[7], np.float64))
        with TimeMeasurement("vio_marg_events"):
            for s_ in victims:
                imu.record_marg_event(
                    ev_slot_fids[s_], ev_slots, ev_slot_fids, H_ev, b_ev,
                    removed_pairs, slot_fid_map, fej_snap, st0)
                # Only the first event carries the quadratic content.
                H_ev = np.zeros((C_ext, C_ext))
                b_ev = np.zeros(C_ext)
                removed_pairs = []
        # 2) Per victim: diagonal priors into HM, Schur, free the slot.
        for s in victims:
            pr_vis = np.array(w.prior_diag)
            pr_imu = np.array(imu.prior_diag)
            i0 = ba_solve.CPART + 8 * s
            j0 = vio_ba.imu_offset(F, s)
            idx = np.concatenate([np.arange(i0, i0 + 8),
                                  np.arange(j0, j0 + 9)])
            imu.HM[idx, idx] += np.concatenate(
                [pr_vis[i0:i0 + 8] * vio_ba.W_DSO, pr_imu[j0:j0 + 9]])
            pr_vis[i0:i0 + 8] = 0.0
            pr_imu[j0:j0 + 9] = 0.0
            w.prior_diag = pr_vis
            imu.prior_diag = pr_imu
            mmask = np.zeros(C_ext, bool)
            mmask[idx] = True
            imu.HM, imu.bM0 = vio_ba.schur_out_np(imu.HM, imu.bM0, mmask)
            w.frames, w.pair_mask = window_ops.drop_frame_slot(
                w.frames, w.pair_mask, s)

    def _active_visual_event(self):
        """The active window's reduced visual system as a quadratic over
        the current keyframes (getActiveDSOFactor): every active point's
        idepth marginalized out of the photometric system at the FEJ
        states. Returns (device refs, build) for maybe_run_pgba, which
        fetches the refs with its own snapshot and calls build on them."""
        w = self.win
        F = self.cfg.f_max
        imu = self.imu
        H_add, b_add = ba.marginalization_update(self._problem(), w.images,
                                                 w.points.mask)
        H_ext = vio_ba.embed_vis(H_add * vio_ba.W_DSO, F)
        b_ext = vio_ba.embed_vis(b_add * vio_ba.W_DSO, F)
        slots = w.slots_by_age()
        fids = [w.slot_frame_id[s_] for s_ in slots]
        slot_fids = list(w.slot_frame_id)
        st = imu.states
        refs = (H_ext, b_ext, w.frames.R0_cw, w.frames.t0_cw,
                w.frames.aff0, st.v0, st.bg0, st.ba0, st.s_log0, st.g20)

        def build(pack):
            (H_np, b_np, R0, t0, aff0, v0, bg0, ba0, s0, g20) = pack
            H_ev, b_ev = imu.cext_to_event(
                np.asarray(H_np, np.float64), np.asarray(b_np, np.float64),
                slots)
            fej = imu.build_kf_snapshot((R0, t0, aff0, v0, bg0, ba0),
                                        slot_fids)
            return delayed.MargEvent(
                victim=-1, fids=fids, H=H_ev, b0=b_ev,
                fej={f: fej[f] for f in fids if f in fej},
                s_log0=float(s0), g20=np.asarray(g20, np.float64))

        return refs, build

    # ------------------------------------------------------------------
    # Deferred keyframes (realtime): _make_keyframe_rt* dispatch the device
    # half (insert, activate, BA, fused tail, tracker reference, spawn)
    # and start the host copy of the tail's results; _finalize_kf* later
    # read that copy and do the host half (the reference's mapping thread,
    # FullSystem.cpp:1216, IMUIntegration.cpp:228-330).
    def _kf_insert(self, pyr, fid, R_cw, t_cw, aff_new, shell_idx: int):
        """Occupy a window slot with the new keyframe; returns the slot."""
        cfg = self.cfg
        w = self.win
        slot = w.free_frame_slot()
        w.insert_frame(slot, fid, pyr, R_cw, t_cw, aff_new)
        w.set_frame_prior(slot, 0.0, cfg.aff_a_prior, cfg.aff_b_prior)
        self.shells[shell_idx].is_kf = True
        self.stats_kf += 1
        return slot

    def _kf_rmse_dev(self, ba_res) -> torch.Tensor:
        """Init-health RMSE, checked at finalize on keyframes 2-4."""
        if self.stats_kf <= 4:
            return self._ba_rmse_dev(ba_res)
        return torch.zeros((), device=self.device)

    def _kf_switch_reference(self, slot: int, fid: int, pyr) -> int:
        """Device half of the reference switch: build the tracker
        reference and spawn immature points in the new keyframe, and
        record the switch on the host (later frames compose against the
        new slot; its pose arrives with the finalize). Returns the previous
        reference's frame id."""
        with TimeMeasurement("tracker_ref"):
            self._build_tracker_ref_dev(slot)
        with TimeMeasurement("spawn_immatures"):
            self._spawn_immatures(slot, pyr)
        prev_ref = self.ref_kf_id
        self.ref_kf_slot = slot
        self.ref_kf_id = fid
        self._kf_epoch_fid = fid
        self._kf_score_meas = None
        return prev_ref

    def _make_keyframe_rt(self, pyr, fid, R_cw, t_cw, aff_new,
                          shell_idx: int) -> None:
        """Deferred visual keyframe."""
        w = self.win
        slot = self._kf_insert(pyr, fid, R_cw, t_cw, aff_new, shell_idx)
        with TimeMeasurement("activate"):
            self._activate_points(slot)
        snap = (w.frames, w.points, w.pair_mask, w.calib, None)
        with TimeMeasurement("ba_optimize"):
            ba_res = self._run_ba(max_iters=self.cfg.ba_iters)
        rmse_d = self._kf_rmse_dev(ba_res)
        w.frames = window_ops.set_fej_current(w.frames, slot)
        vlist, HM, bM, pts, pm, n_pre, n_post = \
            self._dispatch_marg_fused(slot)
        prev_ref = self._kf_switch_reference(slot, fid, pyr)
        refs = (vlist, HM, bM, n_pre, n_post,
                window_ops.kf_pose_pack(w.frames), rmse_d,
                self._frame_th_dev)
        self._kf_finalize = dict(
            slot=slot, fid=fid, snap=snap, prev_ref=prev_ref,
            kf_count=self.stats_kf, future=self._fetcher.submit(refs),
            pts=pts, pm=pm)

    def _make_keyframe_rt_vio(self, pyr, fid, R_cw, t_cw, aff_new,
                              shell_idx: int, ref_pose_approx=None,
                              pred_v_override=None) -> None:
        """Deferred keyframe with an IMU: the keyframe-to-keyframe chunk
        stops at this frame, the extended tail runs once the IMU is
        ACTIVE (the visual one before). ref_pose_approx: the keyframe's
        tracked or predicted pose, the host reference pose for IMU priors
        until the optimized one lands; pred_v_override: the preview's
        velocity at this frame (dispatch-time keyframes)."""
        w = self.win
        imu = self.imu
        prev_slot = self.ref_kf_slot
        slot = self._kf_insert(pyr, fid, R_cw, t_cw, aff_new, shell_idx)
        pred_v = pred_v_override
        if pred_v is None and imu.coarse is not None:
            pred_v = np.asarray(imu.coarse.v)
        with TimeMeasurement("imu_kf_pair"):
            prev_fid = (w.slot_frame_id[prev_slot] if prev_slot >= 0
                        else None)
            imu.on_new_keyframe(prev_slot, slot, pred_v, upto_fid=fid,
                                fids=(prev_fid, fid))
        with TimeMeasurement("activate"):
            self._activate_points(slot)
        snap = (w.frames, w.points, w.pair_mask, w.calib, imu.states)
        with TimeMeasurement("ba_optimize"):
            ba_res = self._run_ba(max_iters=self.cfg.ba_iters)
        rmse_d = self._kf_rmse_dev(ba_res)
        w.frames = window_ops.set_fej_current(w.frames, slot)
        self._imu_set_fej(slot)
        if self._vio_mode():
            with TimeMeasurement("kf_dispatch_tail"):
                refs, pts, pm = self._dispatch_vio_tail(slot)
            kind = "vio"
        else:
            vlist, HM, bM, pts, pm, n_pre, n_post = \
                self._dispatch_marg_fused(slot)
            refs = (vlist, HM, bM, n_pre, n_post,
                    window_ops.kf_pose_pack(w.frames), self._frame_th_dev)
            kind = "visual_imu"
        prev_ref = self._kf_switch_reference(slot, fid, pyr)
        self._kf_finalize = dict(
            kind=kind, slot=slot, fid=fid, snap=snap, prev_ref=prev_ref,
            kf_count=self.stats_kf, ref_pose_approx=ref_pose_approx,
            future=self._fetcher.submit(refs + (rmse_d,)), pts=pts, pm=pm)
        # Chunks consumed while this finalize is pending, replayed after
        # the coarse-filter reseed.
        self._rt_chunks_since_kf = []

    def _finalize_reset_if_init_failed(self, kfp, rmse) -> bool:
        """Init-health check one frame late: on failure rebuild from the
        newest in-flight frame (or the keyframe's own pyramid)."""
        if not self._init_failed(float(rmse), int(kfp["kf_count"])):
            return False
        src = self._rt_queue[-1] if self._rt_queue else None
        if src is not None:
            self._full_reset(src["pyr"], src["ts"], src["fid"])
        else:
            self._full_reset(self.win.pyramids[kfp["slot"]], 0.0, kfp["fid"])
        return True

    def _finalize_common(self, kfp, pose_pack_np) -> np.ndarray:
        """Pose caches and the host half of the reference switch; patch
        in-flight frames tracked against this reference before its pose
        reached the host."""
        pose_pack = self._record_kf_poses(pose_pack_np)
        self._tracker_ref_host_update(kfp["slot"], kfp["fid"], pose_pack_np,
                                      prev_ref_id=kfp["prev_ref"])
        for q in self._rt_queue:
            if q["ref_pose"] is None:
                q["ref_pose"] = self.ref_pose_np
                q["ref_kf_id"] = self.ref_kf_id
        self._publish_keyframe_events()
        return pose_pack

    def _finalize_kf_vio(self, kfp) -> None:
        """Host half of a deferred keyframe with an IMU."""
        w = self.win
        imu = self.imu
        slot, fid = kfp["slot"], kfp["fid"]
        with TimeMeasurement("kf_finalize_fetch"):
            fetched = kfp["future"].result()
        fetched, rmse_np = fetched[:-1], fetched[-1]
        if self._finalize_reset_if_init_failed(kfp, rmse_np):
            return
        n_pre = float(fetched[5] if kfp["kind"] == "vio" else fetched[3])
        if self._n_active > 60 and n_pre < max(40.0, 0.15 * self._n_active):
            # Rare divergence revert, frames late: restore the snapshot and
            # redo the tail synchronously.
            w.frames, w.points, w.pair_mask, w.calib = kfp["snap"][:4]
            if kfp["snap"][4] is not None:
                imu.states = kfp["snap"][4]
            self.calib = w.calib
            w.frames = window_ops.set_fej_current(w.frames, slot)
            if kfp["kind"] == "vio":
                pose_pack_np = self._kf_fused_tail_vio(slot, kfp["snap"])
            else:
                pose_pack_np = self._kf_fused_tail(slot, kfp["snap"])
            self._build_tracker_ref_dev(slot)
        elif kfp["kind"] == "vio":
            with TimeMeasurement("kf_apply_host"):
                pose_pack_np = self._apply_vio_tail_host(
                    fetched, kfp["pts"], kfp["pm"])
        else:
            (vlist, HM_np, bM_np, _, n_post, pose_pack_np,
             self._frame_th_np) = fetched
            self._n_active = float(n_post)
            self._apply_marg_host(vlist, HM_np, bM_np, kfp["pts"], kfp["pm"])
        pose_pack = self._finalize_common(kfp, pose_pack_np)

        # The inertial phase machine (postBAInit seam), frames late.
        if imu.phase == imu_system.COARSE_INIT:
            if imu.try_initialize(self.kf_poses):
                self._imu_activate(slot)
        if imu.phase == imu_system.ACTIVE:
            with TimeMeasurement("pgba_maybe"):
                adopted = imu.maybe_run_pgba(
                    w.frames, w.slot_frame_id,
                    active_event_fn=self._active_visual_event,
                    submit_fn=self._fetcher.submit)
            F = self.cfg.f_max
            R_np = pose_pack[:9 * F].reshape(F, 3, 3)[slot]
            t_np = pose_pack[9 * F:12 * F].reshape(F, 3)[slot]
            # The states rode the vio copy; after a PGBA adoption (new
            # states) or on the activation keyframe (visual tail) they are
            # read again inside.
            st_np = None if (adopted or kfp["kind"] != "vio") \
                else self._kf_st_host
            with TimeMeasurement("coarse_reseed"):
                imu.reinit_coarse_from_ba(R_np, t_np, slot, st_np=st_np)
                # The belief now sits at the keyframe, possibly ahead of
                # the consume position; replay the post-keyframe chunks
                # consumed since (their visual fusion is lost).
                self._belief_fid = max(self._belief_fid, fid)
                for fid_ch, ch in (self._rt_chunks_since_kf or []):
                    imu.predict_coarse(ch)
                    self._belief_fid = fid_ch
            self._kf_st_host = None
        self._rt_chunks_since_kf = None

    def _finalize_kf(self) -> None:
        """Host half of the deferred keyframe, if one is pending."""
        kfp = self._kf_finalize
        if kfp is None:
            return
        self._kf_finalize = None
        if "kind" in kfp:
            self._finalize_kf_vio(kfp)
            return
        w = self.win
        slot = kfp["slot"]
        with TimeMeasurement("kf_finalize_fetch"):
            (vlist, HM_np, bM_np, n_pre, n_post, pose_pack_np, rmse_np,
             self._frame_th_np) = kfp["future"].result()
        if self._finalize_reset_if_init_failed(kfp, rmse_np):
            return
        if self._n_active > 60 and \
                float(n_pre) < max(40.0, 0.15 * self._n_active):
            # Rare divergence revert, frames late.
            w.frames, w.points, w.pair_mask, w.calib = kfp["snap"][:4]
            self.calib = w.calib
            w.frames = window_ops.set_fej_current(w.frames, slot)
            pose_pack_np = self._kf_fused_tail(slot, kfp["snap"])
            self._build_tracker_ref_dev(slot)
        else:
            self._n_active = float(n_post)
            self._apply_marg_host(vlist, HM_np, bM_np, kfp["pts"], kfp["pm"])
        self._finalize_common(kfp, pose_pack_np)

    # ------------------------------------------------------------------
    def _build_tracker_ref_dev(self, slot: int) -> None:
        """Project all points into the new KF and build the semi-dense
        tracking reference (makeCoarseDepthL0)."""
        w = self.win
        u_p, v_p, d_p, valid = window_ops.project_into(
            w.frames, w.points.host, w.points.u, w.points.v,
            w.points.idepth, w.calib, slot)
        hosted = w.points.host == slot
        u_c = torch.where(hosted, w.points.u, u_p)
        v_c = torch.where(hosted, w.points.v, v_p)
        d_c = torch.where(hosted, w.points.idepth, d_p)
        m_c = w.points.mask & (hosted | valid)
        self.tracker_ref = coarse_tracker.make_tracker_ref(
            w.pyramids[slot], w.calib, u_c, v_c, d_c, m_c)
        # Kept for the depth-map publish; copied only when a wrapper asks.
        self._ref_depth_dev = (u_c, v_c, d_c, m_c, w.pyramids[slot][0])

    def _tracker_ref_host_update(self, slot: int, fid: int,
                                 pose_pack: np.ndarray,
                                 prev_ref_id: Optional[int] = None) -> None:
        """Pose caches + motion-model rebase from a fetched pose pack.
        prev_ref_id names the previous reference when a deferred keyframe
        already recorded the switch at dispatch time."""
        F = self.cfg.f_max
        prev = self.ref_kf_id if prev_ref_id is None else prev_ref_id
        R_new_ref = pose_pack[:9 * F].reshape(F, 3, 3)[slot]
        t_new_ref = pose_pack[9 * F:12 * F].reshape(F, 3)[slot]
        aff_ref = pose_pack[12 * F:14 * F].reshape(F, 2)[slot]
        if prev in self.kf_poses and prev != fid:
            R_old, t_old = self.kf_poses[prev]
            lR, lt = self.T_last_ref
            R_w = lR @ R_old
            t_w = lR @ t_old + lt
            nR = R_w @ R_new_ref.T
            nt = t_w - nR @ t_new_ref
            self.T_last_ref = (nR.astype(np.float32), nt.astype(np.float32))
        else:
            self.T_last_ref = (np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32))
        self.ref_pose_np = (R_new_ref.copy(), t_new_ref.copy())
        self.ref_aff_np = aff_ref.copy()
        self.ref_kf_slot = slot
        self.ref_kf_id = fid
        self.last_rho = 0.0
        self.last_b = 0.0
        if self._kf_epoch_fid != fid:
            # Synchronous reference switch (initializer handoff, serial
            # keyframes): a fresh dispatch-decision epoch. Deferred
            # keyframes started theirs at dispatch.
            self._kf_epoch_fid = fid
            self._kf_score_meas = None

    def _set_tracker_ref(self, slot: int, fid: int,
                         pose_pack: Optional[np.ndarray] = None):
        if pose_pack is None:
            pose_pack = _np(window_ops.kf_pose_pack(self.win.frames))
        self._build_tracker_ref_dev(slot)
        self._tracker_ref_host_update(slot, fid, pose_pack)

    def _spawn_immatures(self, slot: int, pyr):
        """Select new candidate points in the newest KF (makeNewTraces)."""
        self.imm = window_ops.respawn_immatures(
            self.imm, self.win.frames, self.win.points, pyr[0],
            self.win.calib, slot, h=self.h, w=self.w)

    # ------------------------------------------------------------------
    # Observer chain: the reference's Output3DWrapper events.
    def _publish_pose(self, fid: int, ts: float, R_cw, t_cw) -> None:
        """Tracked pose of a frame, and the system status when it
        changed."""
        status = (ow.VISUAL_INERTIAL if self._vio_mode()
                  else ow.VISUAL_ONLY)
        for w_ in self.output_wrappers:
            w_.publish_cam_pose(fid, ts, R_cw, t_cw)
            if status != self._published_status:
                w_.publish_system_status(status)
        self._published_status = status

    def _publish_keyframe_events(self) -> None:
        """Per keyframe: window poses, connectivity, the newest keyframe's
        energy threshold, the metric transform; its depth map and
        inertial state only for a wrapper that wants them, read in one
        copy to the host."""
        if not self.output_wrappers:
            return
        w = self.win
        win_fids = [f for f in w.slot_frame_id if f is not None]
        conn = {f: [g for g in win_fids if g != f] for f in win_fids}
        want_depth = any(getattr(w_, "wants_depth_images", False)
                         for w_ in self.output_wrappers)
        want_imu = self._vio_mode() and any(
            getattr(w_, "wants_imu_state", False)
            for w_ in self.output_wrappers)
        refs = []
        if want_depth:
            u_d, v_d, d_d, m_d, img_d = self._ref_depth_dev
            refs += [u_d, v_d, d_d, m_d, img_d[0] if img_d.dim() == 3
                     else img_d]
        if want_imu:
            slot = self.ref_kf_slot
            st = self.imu.states
            refs += [st.v[slot], st.bg[slot], st.ba[slot]]
        host = _fetch_flat(refs) if refs else []
        depth_pack = None
        if want_depth:
            u_np, v_np, d_np, m_np, img_np = host[:5]
            sel = m_np > 0.5
            depth_pack = (u_np[sel], v_np[sel], d_np[sel], img_np)
        th_new = (float(self._frame_th_np[self.ref_kf_slot])
                  if self._frame_th_np is not None else None)
        for w_ in self.output_wrappers:
            w_.publish_keyframes(dict(self.kf_poses))
            w_.publish_graph(conn)
            if th_new is not None:
                w_.publish_frame_energy_th(self.ref_kf_id, th_new)
            if depth_pack is not None:
                w_.push_depth_image(self.ref_kf_id, depth_pack[0],
                                    depth_pack[1], depth_pack[2],
                                    img=depth_pack[3])
            if self._vio_mode():
                w_.publish_transform_dso_to_imu(
                    float(np.exp(self.imu.s_log)), self.imu.g2)
        if want_imu:
            # The reference's per-BA scale / bias / gravity / velocity
            # streams (BAIMULogic.cpp:88-91, 439-455).
            v_np, bg_np, ba_np = host[-3:]
            R_g = lie.so3_exp(torch.tensor(
                [self.imu.g2[0], self.imu.g2[1], 0.0],
                dtype=torch.float32)).numpy()
            g_dir = R_g @ np.array([0.0, 0.0, -1.0])
            sh = next((s for s in reversed(self.shells)
                       if s.frame_id == self.ref_kf_id), None)
            ts = sh.timestamp if sh is not None else 0.0
            for w_ in self.output_wrappers:
                if getattr(w_, "wants_imu_state", False):
                    w_.publish_imu_state(
                        ts, float(np.exp(self.imu.s_log)), bg_np, ba_np,
                        v_np, g_dir)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Serialize the complete odometry state (a capability DM-VIO
        lacks): every tensor as CPU numpy."""
        from dmvio_tpu_torch.utils import checkpoint
        checkpoint.save(self, path)

    @staticmethod
    def load_checkpoint(path: str, device=None) -> "FullSystem":
        """Restore a FullSystem onto `device` (None means CUDA, and raises
        without it), wherever it was saved."""
        from dmvio_tpu_torch.utils import checkpoint
        return checkpoint.load(path, device=device)

    # ------------------------------------------------------------------
    def metric_trajectory(self):
        """Body poses in the metric gravity-aligned world (resultScaled.txt
        via TransformDSOToIMU::transformPose) as (timestamp, R_wb, p_wb);
        None until the IMU is ACTIVE. Host math on the CPU."""
        if not self._vio_mode():
            return None
        st = imu_system.to_host(self.imu.states)
        dso = self.trajectory()
        R_wc = torch.as_tensor(np.stack([p[1] for p in dso]))
        t_wc = torch.as_tensor(np.stack([p[2] for p in dso]))
        R_cw, t_cw = lie.se3_inv(R_wc, t_wc)
        Rb, pb = vio_ba.dso_to_body(
            R_cw, t_cw, torch.as_tensor(np.float32(st.s_log)),
            torch.as_tensor(np.asarray(st.g2, np.float32)),
            self.imu.R_cb.cpu(), self.imu.t_cb.cpu())
        Rb, pb = Rb.numpy(), pb.numpy()
        return [(dso[i][0], Rb[i], pb[i]) for i in range(len(dso))]

    def trajectory(self):
        """All frame poses as cam-to-world (timestamp, R_wc, t_wc)."""
        self.finish()
        out = []
        for sh in self.shells:
            if sh.frame_id in self.kf_poses:
                R_cw, t_cw = self.kf_poses[sh.frame_id]
            elif sh.ref_kf_id in self.kf_poses:
                R_ref, t_ref = self.kf_poses[sh.ref_kf_id]
                R_cw, t_cw = lie.se3_mul(
                    *(torch.as_tensor(np.asarray(x), dtype=torch.float32)
                      for x in (sh.R_c_ref, sh.t_c_ref, R_ref, t_ref)))
                R_cw, t_cw = R_cw.numpy(), t_cw.numpy()
            else:
                R_cw, t_cw = sh.R_c_ref, sh.t_c_ref
            R_wc, t_wc = lie.se3_inv(
                torch.as_tensor(np.asarray(R_cw), dtype=torch.float32),
                torch.as_tensor(np.asarray(t_cw), dtype=torch.float32))
            out.append((sh.timestamp, R_wc.numpy(), t_wc.numpy()))
        return out
