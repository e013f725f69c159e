"""Carry estimator state from numpy arrays into the port's tensors.

The system has no learned weights; what must carry across between
implementations is its state: the calibration, the window's frames and
points (`BAFrames`, `BAPoints`), the immature pool, the tracker reference
(pyramid + per-level `PointCloud`s), the window's `pair_mask`, the
host-side prior (`HM`, `bM0` float64, `prior_diag`), and the inertial
state: `VIOStates`, `IMUPairs` with their `PreintState`s, the coarse
filter's `CoarseIMUState` (host float64) and the IMU system's host prior.

Every function takes objects whose fields are numpy arrays (or anything
`np.asarray` accepts: NamedTuples, dataclasses, dicts) and matches fields
BY NAME, so state fetched from another implementation converts without
importing its types. Dtypes are kept (float32, int32, bool); the prior
stays numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dmvio_tpu_torch.models import coarse_tracker, vio_ba, vio_coarse
from dmvio_tpu_torch.ops import align, immature, preint, residuals
from dmvio_tpu_torch.utils.camera import Calib


def _field(src: Any, name: str):
    if isinstance(src, dict):
        return src[name]
    return getattr(src, name)


def tensor(x, device) -> torch.Tensor:
    """numpy-like -> tensor on `device`, dtype preserved (float64 -> f32).
    The data is copied: arrays fetched from another framework are often
    read-only."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def named(cls, src: Any, device):
    """Build NamedTuple `cls` from the same-named fields of `src`."""
    return cls(**{f: tensor(_field(src, f), device) for f in cls._fields})


def calib(src: Any, device) -> Calib:
    return Calib.create(*(float(np.asarray(_field(src, f)))
                          for f in ("fx", "fy", "cx", "cy")), device=device)


def frames(src: Any, device) -> residuals.BAFrames:
    return named(residuals.BAFrames, src, device)


def points(src: Any, device) -> residuals.BAPoints:
    return named(residuals.BAPoints, src, device)


def immature_pool(src: Any, device) -> immature.ImmaturePoints:
    return named(immature.ImmaturePoints, src, device)


def point_cloud(src: Any, device) -> align.PointCloud:
    return named(align.PointCloud, src, device)


def tracker_ref(src: Any, device) -> coarse_tracker.TrackerRef:
    return coarse_tracker.TrackerRef(
        pyr=tuple(tensor(p, device) for p in _field(src, "pyr")),
        clouds=tuple(point_cloud(c, device)
                     for c in _field(src, "clouds")))


def window_state(win: Any, device) -> dict:
    """The window of a FullSystem-like object: frames, points, pair_mask,
    calib, images on `device`; HM/bM0 float64 and prior_diag float32 numpy."""
    return dict(
        frames=frames(_field(win, "frames"), device),
        points=points(_field(win, "points"), device),
        pair_mask=tensor(_field(win, "pair_mask"), device).to(torch.bool),
        calib=calib(_field(win, "calib"), device),
        calib0=tensor(_field(win, "calib0"), device),
        images=tensor(_field(win, "images"), device),
        HM=np.asarray(_field(win, "HM"), np.float64),
        bM0=np.asarray(_field(win, "bM0"), np.float64),
        prior_diag=np.asarray(_field(win, "prior_diag"), np.float32),
    )


def preint_state(src: Any, device) -> preint.PreintState:
    return named(preint.PreintState, src, device)


def vio_states(src: Any, device) -> vio_ba.VIOStates:
    return named(vio_ba.VIOStates, src, device)


def imu_pairs(src: Any, device) -> vio_ba.IMUPairs:
    return vio_ba.IMUPairs(
        pre=preint_state(_field(src, "pre"), device),
        i=tensor(_field(src, "i"), device).long(),
        j=tensor(_field(src, "j"), device).long(),
        valid=tensor(_field(src, "valid"), device).to(torch.bool))


def coarse_imu_state(src: Any) -> vio_coarse.CoarseIMUState:
    """The coarse filter's belief, host float64 as in both
    implementations."""
    return vio_coarse.CoarseIMUState(
        R_cw=np.asarray(_field(src, "R_cw"), np.float64),
        t_cw=np.asarray(_field(src, "t_cw"), np.float64),
        v=np.asarray(_field(src, "v"), np.float64),
        bias=np.asarray(_field(src, "bias"), np.float64),
        H=np.asarray(_field(src, "H"), np.float64),
        s_log=float(np.asarray(_field(src, "s_log"))),
        g2=np.asarray(_field(src, "g2"), np.float64))


def imu_host_state(imu: Any) -> dict:
    """The IMU system's host state: the extended prior (HM, bM0 float64;
    prior_diag float32), s_log, g2, and the pairs as (older slot, newer
    slot, host preint dict); a pair given as (i, j, device preint, host
    dict) keeps its host dict."""
    return dict(
        HM=np.asarray(_field(imu, "HM"), np.float64),
        bM0=np.asarray(_field(imu, "bM0"), np.float64),
        prior_diag=np.asarray(_field(imu, "prior_diag"), np.float32),
        s_log=float(_field(imu, "s_log")),
        g2=np.asarray(_field(imu, "g2"), np.float64),
        pairs=[(int(p[0]), int(p[1]), p[-1]) for p in _field(imu, "pairs")])
