"""Monocular visual initializer.

Counterpart of dmvio_tpu/models/initializer.py (CoarseInitializer): joint
pose + per-point inverse-depth GN against the first frame for several
seeded hypotheses at once (ops/init_gn), warm-started across frames, with
the "snapped" criterion and the wait-after-snap before the handoff.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dmvio_tpu_torch.ops import init_gn, interp, select
from dmvio_tpu_torch.utils.camera import Calib, pattern


class InitResult(NamedTuple):
    R: torch.Tensor        # world-to-cam of the second keyframe (first = id)
    t: torch.Tensor
    rho: torch.Tensor      # relative brightness gain (log) first -> second
    b_aff: torch.Tensor
    u: torch.Tensor        # [N] point pixels in the first frame
    v: torch.Tensor
    idepth: torch.Tensor   # [N] normalized so median == 1
    color: torch.Tensor    # [N, 8]
    weight: torch.Tensor   # [N, 8]
    mask: torch.Tensor     # [N]
    scale: float           # median-idepth normalization applied (t *= scale)


class VisualInitializer:
    """Stateful two-frame initializer (host control, batched GN core)."""

    WAIT_AFTER_SNAP = 5
    N_CAND = 7
    SEED_T = 0.05

    def __init__(self, calib: Calib, h: int, w: int, n_points: int = 1024,
                 levels: int = 6, min_parallax: float = 0.008,
                 rounds: int = 2):
        self.calib = calib
        self.device = calib.device
        self.h, self.w = h, w
        self.n = n_points
        self.levels = levels
        self.first_pyr = None
        self.sel = None
        self.colors = None
        self.weights = None
        self.last_R = torch.eye(3, device=self.device)
        self.last_t = torch.zeros(3, device=self.device)
        self.frames_since_first = 0
        self._reset_candidates()

    def _seed_t(self) -> torch.Tensor:
        dirs = np.array([
            [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
            [0, 0, 1], [0, 0, -1]], np.float32)
        return torch.as_tensor(np.float32(self.SEED_T) * dirs,
                               device=self.device)

    def _reset_candidates(self) -> None:
        C, n, dev = self.N_CAND, self.n, self.device
        self.c_R = torch.eye(3, device=dev).expand(C, 3, 3).clone()
        self.c_t = self._seed_t()
        self.c_rho = torch.zeros(C, device=dev)
        self.c_b = torch.zeros(C, device=dev)
        self.c_idepth = torch.ones(C, n, device=dev)
        self.snap_streak = np.zeros(C, np.int32)

    def set_first(self, pyr) -> None:
        self.first_pyr = pyr
        self.sel = select.select_points(pyr[0], self.n, pot=4)
        pat = pattern(self.device)
        samp = interp.bilinear_stack(
            pyr[0], self.sel.u[:, None] + pat[:, 0],
            self.sel.v[:, None] + pat[:, 1])                  # [N, 8, 3]
        self.colors = samp[..., 0]
        g2 = samp[..., 1] ** 2 + samp[..., 2] ** 2
        self.weights = torch.sqrt(2500.0 / (2500.0 + g2))
        self.last_R = torch.eye(3, device=self.device)
        self.last_t = torch.zeros(3, device=self.device)
        self.frames_since_first = 0
        self._reset_candidates()

    def shift_rho(self, dlog: float) -> None:
        """Shift every hypothesis' log-gain warm start by a known
        log-exposure ratio."""
        self.c_rho = self.c_rho + float(np.float32(dlog))

    def try_init(self, new_pyr) -> Optional[InitResult]:
        """Track this frame for all hypotheses; return InitResult once the
        best hypothesis has been snapped long enough."""
        self.frames_since_first += 1
        R, t, rho, b_aff, idepth, packed = init_gn.init_track_multi(
            self.first_pyr, new_pyr, self.calib,
            self.sel.u, self.sel.v, self.sel.mask,
            self.c_R, self.c_t, self.c_rho, self.c_b, self.c_idepth,
            levels=self.levels)
        pk = packed.cpu().numpy()                 # [C, 17]: one host read
        snapped = pk[:, 14] > 0.5
        finite = pk[:, 15] > 0.5
        energy = pk[:, 16]

        e_eff = np.where(finite, energy, np.inf)
        best = int(np.argmin(np.where(snapped, e_eff, np.inf)
                             if snapped.any() else e_eff))
        self.last_R = R[best]
        self.last_t = t[best]

        # Only the winner continues; every other hypothesis restarts from
        # its seed with the winner's rotation (see dmvio_tpu).
        C = self.N_CAND
        if finite[best]:
            self.c_R = R[best].expand(C, 3, 3).clone()
            self.c_t = torch.cat([t[best][None], self._seed_t()[1:]])
            self.c_rho = rho[best].expand(C).clone()
            self.c_b = b_aff[best].expand(C).clone()
            self.c_idepth = torch.cat(
                [idepth[best][None],
                 torch.ones(C - 1, self.n, device=self.device)])
        else:
            self._reset_candidates()
        self.snap_streak = np.where(snapped & finite,
                                    self.snap_streak + 1, 0)

        ready = (snapped & finite
                 & (self.snap_streak >= self.WAIT_AFTER_SNAP))
        if not ready.any():
            return None
        c = int(np.argmin(np.where(snapped & finite, e_eff, np.inf)))

        d = idepth[c].cpu().numpy()
        m = self.sel.mask.cpu().numpy() & np.isfinite(d) & (d > 1e-3) & \
            (d < 50.0)
        if m.sum() < 0.2 * self.n:
            return None
        med = float(np.median(d[m]))
        if not np.isfinite(med) or med <= 1e-4:
            return None
        # Normalize scale: median idepth -> 1 (t *= med keeps projections).
        return InitResult(
            R=R[c], t=t[c] * med, rho=rho[c], b_aff=b_aff[c],
            u=self.sel.u, v=self.sel.v,
            idepth=torch.as_tensor(d / med, device=self.device),
            color=self.colors, weight=self.weights,
            mask=torch.as_tensor(m, device=self.device),
            scale=med,
        )
