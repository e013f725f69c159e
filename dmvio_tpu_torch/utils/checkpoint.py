"""Checkpoint / resume of the full odometry state.

Counterpart of dmvio_tpu/utils/checkpoint.py. DM-VIO has no checkpointing
(runs restart from scratch); the JAX package added it: the sliding window,
the marginalization priors, the immature pool, the IMU side state (with
the delayed-marginalization log and the PGBA bookkeeping) and the host
metadata are O(MB) and go into one pickle. Every tensor is stored as CPU
numpy, so a checkpoint written on the card loads on the CPU and back. A
resumed system continues processing frames as if never stopped; the
tracker reference is rebuilt from the stored keyframe pyramids.

A realtime system is saved as it stands: flush it with `finish()` first,
or the frames still in flight are not part of the checkpoint.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

import dmvio_tpu_torch
from dmvio_tpu_torch.utils.fetch import to_host

# FullSystem attributes stored as they are (host values).
_HOST_FIELDS = ("initialized", "frame_id", "first_id", "shells", "kf_poses",
                "ref_kf_slot", "ref_kf_id", "ref_pose_np", "ref_aff_np",
                "T_last_ref", "motion", "last_rho", "last_b",
                "track_energy_ref", "_n_active", "stats_kf",
                "stats_lost_frames", "stats_resets", "_last_exposure")
# IMUSystem attributes stored as they are (host values: NumPy, float64
# priors, the coarse filter's belief, host preintegrations, the delayed log).
_IMU_HOST_FIELDS = ("calib", "phase", "pairs", "HM", "bM0", "prior_diag",
                    "coarse", "s_log", "g2", "init_result", "_kf_acc",
                    "_kf_gyr", "_kf_dts", "_kf_fids", "_init_poses",
                    "_init_pres", "_init_fids", "_init_dts", "_acc_sum",
                    "_acc_n", "last_frame_pre_np", "_last_chunk_acc_mean",
                    "_pending_pairs", "init_s_var", "delayed_log",
                    "kf_since_pgba", "pgba_count", "pgba_adopt_count",
                    "best_pgba_var", "last_pgba_svar", "_pgba_adopted_once",
                    "scale_fixed", "_s_hist", "_last_init_decent")


def _to_device(tree, dev):
    """numpy arrays -> tensors on `dev` (dtype kept) through tuples, lists
    and NamedTuples; other leaves are kept."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree).to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(a, dev) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(a, dev) for a in tree)
    return tree


def save(fs, path: str) -> None:
    """Serialize a FullSystem to `path` (pickle, tensors as numpy)."""
    w = fs.win
    state: Dict[str, Any] = {
        "cfg": fs.cfg,
        "calib_vec": to_host(fs.calib.as_vec()),
        "h": fs.h, "w": fs.w,
        "frames": to_host(w.frames),
        "points": to_host(w.points),
        "pair_mask": to_host(w.pair_mask),
        "images": to_host(w.images),
        "pyramids": [None if p is None else to_host(list(p))
                     for p in w.pyramids],
        "HM": np.asarray(w.HM), "bM0": np.asarray(w.bM0),
        "prior_diag": np.asarray(w.prior_diag),
        "calib0": to_host(w.calib0),
        "slot_frame_id": list(w.slot_frame_id),
        "kf_count": w.kf_count,
        "imm": to_host(fs.imm),
    }
    for k in _HOST_FIELDS:
        state[k] = getattr(fs, k)
    if fs.imu is not None:
        imu = fs.imu
        st = {k: getattr(imu, k) for k in _IMU_HOST_FIELDS}
        st["states"] = None if imu.states is None else to_host(imu.states)
        state["imu"] = st
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load(path: str, device=None):
    """Restore a FullSystem from `path` onto `device` (None means CUDA, and
    raises without it)."""
    from dmvio_tpu_torch.models import full_system
    from dmvio_tpu_torch.utils.camera import Calib

    dev = dmvio_tpu_torch.device(device)
    with open(path, "rb") as f:
        st = pickle.load(f)

    calib = Calib.from_vec(torch.as_tensor(st["calib_vec"]).to(dev))
    imu_state = st.get("imu")
    fs = full_system.FullSystem(
        calib, st["h"], st["w"], st["cfg"], device=dev,
        imu_calib=imu_state["calib"] if imu_state else None)

    w = fs.win
    w.frames = _to_device(st["frames"], dev)
    w.points = _to_device(st["points"], dev)
    w.pair_mask = _to_device(st["pair_mask"], dev)
    w.images = _to_device(st["images"], dev)
    w.pyramids = [None if p is None else tuple(_to_device(p, dev))
                  for p in st["pyramids"]]
    w.HM = np.asarray(st["HM"], np.float64)
    w.bM0 = np.asarray(st["bM0"], np.float64)
    w.prior_diag = np.asarray(st["prior_diag"])
    w.calib0 = _to_device(st["calib0"], dev)
    w.calib = calib
    w.slot_frame_id = list(st["slot_frame_id"])
    w.kf_count = st["kf_count"]
    fs.imm = _to_device(st["imm"], dev)
    for k in _HOST_FIELDS:
        setattr(fs, k, st[k])

    if imu_state is not None:
        imu = fs.imu
        for k in _IMU_HOST_FIELDS:
            setattr(imu, k, imu_state[k])
        imu.states = None if imu_state["states"] is None \
            else _to_device(imu_state["states"], dev)

    # Rebuild the tracker reference from the stored window.
    if fs.initialized and fs.ref_kf_slot >= 0 \
            and w.pyramids[fs.ref_kf_slot] is not None:
        fs._set_tracker_ref(fs.ref_kf_slot, fs.ref_kf_id)
        # _set_tracker_ref resets the motion model; restore it.
        for k in ("T_last_ref", "motion", "last_rho", "last_b",
                  "ref_kf_id"):
            setattr(fs, k, st[k])
    return fs
