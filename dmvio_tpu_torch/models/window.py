"""Host-side sliding-window state manager (fixed-capacity SoA).

Counterpart of dmvio_tpu/models/window.py: slot allocation for frames and
points, incidence masks, the marginalization prior and per-frame metadata.
Frame/point state lives on the working device; the marginalization prior
(HM, bM0) and the diagonal priors stay host float64/float32 numpy, as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dmvio_tpu_torch.models import window_ops
from dmvio_tpu_torch.ops import ba_solve
from dmvio_tpu_torch.ops.residuals import BAFrames, BAPoints
from dmvio_tpu_torch.utils.camera import Calib


@dataclasses.dataclass
class Config:
    """Runtime knobs, defaults mirroring the reference operating point.
    `mesh_devices` > 1 shards the window BA's point axis over that many
    devices (parallel/dist_ba; on the CPU, that many shards of the CPU).
    The `rt_*` knobs and `async_fetch` steer the
    realtime pipeline (`realtime=True`) with the reference's names,
    defaults and meanings (dmvio_tpu/models/window.py says how each was
    chosen); they were tuned to the TPU's host link, not to this card."""

    f_max: int = 8              # window capacity
    p_max: int = 2048           # active point capacity
    i_max: int = 2048           # immature pool capacity
    max_frames: int = 7         # marginalize down to this many KFs
    ba_iters: int = 6           # setting_maxOptIterations
    levels: int = 6             # PYR_LEVELS
    kf_weight: float = 1.0      # setting_kfGlobalWeight
    w_flow_t: float = 0.04 * (640 + 480)    # setting_maxShiftWeightT
    w_flow_rt: float = 0.02 * (640 + 480)   # setting_maxShiftWeightRT
    w_aff: float = 2.0          # setting_maxAffineWeight
    calib_prior: float = 1e8    # pin intrinsics
    first_pose_prior: float = 1e10
    first_aff_prior: float = 1e10
    aff_a_prior: float = 1e6
    aff_b_prior: float = 1e4
    min_rel_baseline: float = 0.02
    # Pipelined tracking/mapping (the reference's realtime mode): each
    # frame's tracking is dispatched at once and consumed when its result
    # copy has landed; keyframes are decided at dispatch and their host
    # half runs deferred; PGBA runs on a background thread.
    realtime: bool = False
    # The frame loop blocks on the oldest in-flight frame only beyond this
    # many in-flight frames (it also bounds the IMU preview's horizon).
    rt_stall_depth: int = 24
    # Decide keyframes at dispatch time from the newest landed tracker
    # score extrapolated by its per-frame growth; False decides at consume
    # time from each frame's own stats.
    rt_dispatch_kf: bool = True
    # Density factor of the dispatch-time keyframe score (RMS-flow form).
    rt_kf_density: float = 2.0
    # Seconds a keyframe decision waits for the previous keyframe's host
    # copy before stretching the keyframe interval instead.
    rt_kf_wait: float = 0.15
    # Predicted-score multiple of the threshold past which the decision
    # blocks on that copy rather than stretch further.
    rt_kf_stretch: float = 2.0
    # In-flight frames re-tracked against a consume-time keyframe's new
    # reference (the newest ones).
    rt_redispatch_max: int = 24
    # Copy results to the host asynchronously (utils/fetch.py); False
    # copies at submit, which makes the pipeline deterministic.
    async_fetch: bool = True
    track_gate_scale: float = 1.5
    track_gate_offset: float = 0.5
    track_gate_cap: float = 100.0
    mesh_devices: int = 0


@dataclasses.dataclass
class FrameShell:
    """Per-processed-frame record for trajectory output (non-KF poses are
    relative to their tracking reference KF, composed at output time)."""

    frame_id: int
    timestamp: float
    ref_kf_id: int
    R_c_ref: np.ndarray
    t_c_ref: np.ndarray
    is_kf: bool = False


class Window:
    """Fixed-capacity sliding window of keyframes + active points."""

    def __init__(self, calib: Calib, h: int, w: int, cfg: Config):
        self.cfg = cfg
        self.h, self.w = h, w
        dev = calib.device
        self.device = dev
        F, P = cfg.f_max, cfg.p_max
        C = ba_solve.cdim(F)
        f32 = dict(dtype=torch.float32, device=dev)
        eye = torch.eye(3, **f32).expand(F, 3, 3).clone()
        self.frames = BAFrames(
            R_cw=eye, t_cw=torch.zeros(F, 3, **f32),
            aff=torch.zeros(F, 2, **f32), R0_cw=eye.clone(),
            t0_cw=torch.zeros(F, 3, **f32), aff0=torch.zeros(F, 2, **f32),
            mask=torch.zeros(F, dtype=torch.bool, device=dev))
        self.points = BAPoints(
            host=torch.zeros(P, dtype=torch.int32, device=dev),
            u=torch.zeros(P, **f32), v=torch.zeros(P, **f32),
            idepth=torch.ones(P, **f32), idepth_zero=torch.ones(P, **f32),
            color=torch.zeros(P, 8, **f32), weight=torch.ones(P, 8, **f32),
            mask=torch.zeros(P, dtype=torch.bool, device=dev))
        self.pair_mask = torch.zeros(F, P, dtype=torch.bool, device=dev)
        self.calib = calib
        self.calib0 = calib.as_vec()
        # Marginalization prior on HOST in float64 (see ba_solve.schur_out_np).
        self.HM = np.zeros((C, C), np.float64)
        self.bM0 = np.zeros((C,), np.float64)
        prior = np.zeros(C, np.float32)
        prior[:4] = cfg.calib_prior
        self.prior_diag = prior
        self.images = torch.zeros(F, 3, h, w, **f32)
        self.pyramids: List[Optional[tuple]] = [None] * F
        self.slot_frame_id: List[Optional[int]] = [None] * F
        self.kf_count = 0

    def free_frame_slot(self) -> int:
        """First unoccupied slot (host truth: slot_frame_id)."""
        for s, fid in enumerate(self.slot_frame_id):
            if fid is None:
                return s
        raise RuntimeError("window full: marginalize before inserting")

    def newest_slot(self) -> int:
        """Slot of the newest keyframe (host truth: slot_frame_id)."""
        ids = [(-1 if i is None else i) for i in self.slot_frame_id]
        return int(np.argmax(ids))

    def slots_by_age(self):
        """Occupied slots, oldest first (host truth)."""
        occ = [(fid, s) for s, fid in enumerate(self.slot_frame_id)
               if fid is not None]
        return [s for _, s in sorted(occ)]

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def insert_frame(self, slot: int, frame_id: int, pyr: tuple,
                     R_cw, t_cw, aff) -> None:
        self.frames, self.images, self.pair_mask = window_ops.insert_frame(
            self.frames, self.images, self.pair_mask, self.points.mask,
            slot, pyr[0], self._t(R_cw), self._t(t_cw), self._t(aff))
        self.pyramids[slot] = pyr
        self.slot_frame_id[slot] = frame_id
        self.kf_count += 1

    def set_fej_to_current(self, slot: int) -> None:
        self.frames = window_ops.set_fej_current(self.frames, slot)

    def add_points(self, hosts, u, v, idepth, color, weight, valid,
                   score=None) -> None:
        """Admit candidate points into free slots."""
        u = self._t(u)
        if score is None:
            score = torch.ones_like(u)
        self.points, self.pair_mask, _ = window_ops.admit_points(
            self.points, self.pair_mask, self.frames.mask,
            self._t(hosts, torch.int32), u, self._t(v), self._t(idepth),
            self._t(color), self._t(weight), self._t(valid, torch.bool),
            self._t(score))

    def frame_prior_into_HM(self, slot: int) -> None:
        """Move a frame's diagonal prior into HM before marginalization."""
        i0 = ba_solve.CPART + 8 * slot
        pr = np.asarray(self.prior_diag).copy()
        blk = pr[i0:i0 + 8].copy()
        if blk.any():
            idx = np.arange(i0, i0 + 8)
            self.HM[idx, idx] += blk
            pr[i0:i0 + 8] = 0.0
            self.prior_diag = pr

    def set_frame_prior(self, slot: int, pose_prior: float,
                        aff_a_prior: float, aff_b_prior: float) -> None:
        i0 = ba_solve.CPART + 8 * slot
        pr = np.asarray(self.prior_diag).copy()
        pr[i0:i0 + 6] = pose_prior
        pr[i0 + 6] = aff_a_prior
        pr[i0 + 7] = aff_b_prior
        self.prior_diag = pr
