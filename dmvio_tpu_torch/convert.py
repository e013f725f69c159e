"""Carry estimator state from numpy arrays into the port's tensors.

The system has no learned weights; what must carry across between
implementations is its state: the calibration, the window's frames and
points (`BAFrames`, `BAPoints`), the immature pool, the tracker reference
(pyramid + per-level `PointCloud`s), the window's `pair_mask`, and the
host-side prior (`HM`, `bM0` float64, `prior_diag`).

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

from dmvio_tpu_torch.models import coarse_tracker
from dmvio_tpu_torch.ops import align, immature, residuals
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
