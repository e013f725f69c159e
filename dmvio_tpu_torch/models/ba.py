"""Sliding-window photometric bundle adjustment: the LM driver.

Counterpart of dmvio_tpu/models/ba.py (FullSystem::optimize +
EnergyFunctional::solveSystemF). The reference's on-device `while_loop`
is a Python loop here: each iteration solves, steps, relinearizes (kernel
K1 samples every pair), accepts or rejects on the device, and reads one
`done` flag back to decide whether to go on. Energy convention as the
reference: photometric sum(hw w^2 r^2 (2 - hw)) plus the prior energy
delta^T (2 bM0 + HM delta).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvio_tpu_torch.models import window_ops
from dmvio_tpu_torch.ops import ba_solve, residuals
from dmvio_tpu_torch.ops.residuals import BAFrames, BAPoints, OUTLIER_TH
from dmvio_tpu_torch.parallel import dist_ba
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib, PATTERN_NUM

MIN_IDEPTH = 1e-4
MAX_IDEPTH = 50.0
MAX_BA_ITERS = 6
MIN_BA_ITERS = 1

FRAME_TH_QUANTILE = 0.7
FRAME_TH_FAC_MEDIAN = 1.5
FRAME_TH_CONST_WEIGHT = 0.5
FRAME_TH_CONST = 26.0
FRAME_TH_MAX = 5000.0


class BAProblem(NamedTuple):
    """Everything the window optimizer consumes."""

    frames: BAFrames
    points: BAPoints
    calib: Calib
    calib0: torch.Tensor      # [4] linearization point of the intrinsics
    HM: torch.Tensor          # [C, C] marginalization prior (f32 copy)
    bM0: torch.Tensor         # [C]
    prior_diag: torch.Tensor  # [C] diagonal priors
    pair_mask: torch.Tensor   # [F, P] candidate residual incidence


class BAResult(NamedTuple):
    frames: BAFrames
    points: BAPoints
    calib: Calib
    energy: torch.Tensor         # final photometric energy
    iters: torch.Tensor
    pair_outlier: torch.Tensor   # [F, P]
    pair_oob: torch.Tensor       # [F, P]
    pair_energy: torch.Tensor    # [F, P]
    idepth_new: torch.Tensor     # [F, P]
    u_new: torch.Tensor
    v_new: torch.Tensor
    frame_th: torch.Tensor       # [F] adaptive per-frame energy threshold


def frame_energy_th(pair_energy, pair_ok) -> torch.Tensor:
    """Per-frame adaptive outlier threshold (setNewFrameEnergyTH): the
    0.7-quantile pair energy, blended with a constant floor and capped;
    12^2 * patternNum for frames without active pairs.

    A quantile over the point axis is no sum of partials: sharded inputs
    (dist_ba.Placed [F, P/n] parts) are gathered whole first, so the
    threshold is the single-device one exactly."""
    pair_energy = _whole(pair_energy, 1)
    pair_ok = _whole(pair_ok, 1)
    F, P = pair_energy.shape
    e = torch.where(pair_ok, pair_energy,
                    torch.full_like(pair_energy, float("inf")))
    order = torch.sort(e, dim=1).values
    n = torch.sum(pair_ok.to(torch.int32), dim=1)
    idx = torch.clamp((FRAME_TH_QUANTILE * n.to(torch.float32))
                      .to(torch.int32), 0, P - 1).long()
    nth = torch.gather(order, 1, idx[:, None])[:, 0]
    s = torch.sqrt(torch.clamp(nth, min=0.0))
    th = (FRAME_TH_CONST * FRAME_TH_CONST_WEIGHT
          + s * FRAME_TH_FAC_MEDIAN * (1.0 - FRAME_TH_CONST_WEIGHT)) ** 2
    th = torch.clamp(th, max=FRAME_TH_MAX)
    return torch.where(n > 0, th,
                       torch.full_like(th, OUTLIER_TH * PATTERN_NUM))


def _whole(x, dim: int):
    """A Placed per-point value gathered whole; a plain tensor as it is."""
    parts, shards = dist_ba.unplace(x)
    return shards.gather_points(parts, dim)


def _prior_energy(delta, HM, bM0, prior_diag):
    return delta @ (2.0 * bM0 + HM @ delta) + delta @ (prior_diag * delta)


def _apply_step(frames: BAFrames, calib: Calib, dx, F: int):
    cal_new = Calib.from_vec(calib.as_vec() + dx[:4])
    fsteps = dx[4:].reshape(F, 8)
    R_new, t_new = lie.se3_retract(frames.R_cw, frames.t_cw, fsteps[:, :6])
    m = frames.mask
    aff_new = frames.aff + torch.where(m[:, None], fsteps[:, 6:8],
                                       torch.zeros_like(fsteps[:, 6:8]))
    R_new = torch.where(m[:, None, None], R_new, frames.R_cw)
    t_new = torch.where(m[:, None], t_new, frames.t_cw)
    return frames._replace(R_cw=R_new, t_cw=t_new, aff=aff_new), cal_new


def _step_points(points: BAPoints, dxd) -> BAPoints:
    """One shard's idepth step, clamped; inactive points keep theirs."""
    id_new = torch.clamp(points.idepth + dxd, MIN_IDEPTH, MAX_IDEPTH)
    return points._replace(
        idepth=torch.where(points.mask, id_new, points.idepth))


def _select(accept, new, old):
    """torch.where(accept, new, old) over every tensor of nested
    NamedTuples, tuples (per-shard parts) and Calibs; `accept` follows
    each tensor to its shard's device."""
    if isinstance(new, torch.Tensor):
        if accept.device != new.device:
            accept = accept.to(new.device)
        return torch.where(accept, new, old)
    if isinstance(new, Calib):
        return Calib(*(torch.where(accept, getattr(new, f), getattr(old, f))
                       for f in ("fx", "fy", "cx", "cy")))
    if hasattr(new, "_fields"):
        return type(new)(*(_select(accept, a, b) for a, b in zip(new, old)))
    return tuple(_select(accept, a, b) for a, b in zip(new, old))


class _Shards:
    """A window problem's per-shard view: `parts` (one problem per local
    shard, its frame-sized leaves replicated on the shard's device),
    `images` per shard, and the placer that sums and gathers across
    them (dist_ba.ONE for the unsharded call). parts[0] lives on the
    device where the camera-sized work runs."""

    def __init__(self, problem, images):
        self.parts, self.sh = dist_ba.unplace(problem)
        self.images = dist_ba.parts_of(images, self.sh)

    def linearize(self, frames, points, calib, geos=None):
        fr, ca = self.sh.copies(frames), self.sh.copies(calib)
        return [residuals.linearize(
                    fr[k], points[k], ca[k], self.images[k], p.pair_mask,
                    geo=None if geos is None else geos[k])
                for k, p in enumerate(self.parts)]

    def sum(self, xs):
        """Shard sum of per-shard scalars or camera-sized tensors."""
        return self.sh.reduce(list(xs))

    def whole(self, xs, dim: int = 0):
        """Per-point parts gathered whole."""
        return self.sh.gather_points(list(xs), dim)

    def whole_points(self, points) -> BAPoints:
        return BAPoints(*(self.whole(f) for f in zip(*points)))


def optimize(problem: BAProblem, images: torch.Tensor,
             max_iters: int = MAX_BA_ITERS,
             orthogonalize: bool = False) -> BAResult:
    """Run the windowed BA to (approximate) convergence.

    images [F, 3, H, W]: level-0 pyramids of the window frames.
    orthogonalize: project gauge directions out of each step (leave False
    when the gauge is pinned by priors, the default window setup).
    `problem` and `images` may be placed by a dist_ba.Placer: the point
    axis then runs per shard and the result comes back whole."""
    S = _Shards(problem, images)
    base = S.parts[0]
    F = base.frames.mask.shape[0]
    N_null = ba_solve.nullspaces(base.frames, F) if orthogonalize \
        else None
    geos = [residuals.fej_geometry(p.frames, p.points, p.calib)
            for p in S.parts]

    def lin_at(frames, points, calib):
        return S.linearize(frames, points, calib, geos)

    def total_energy(frames, calib, e_photo):
        delta = ba_solve.state_delta(frames, calib, base.calib0)
        return e_photo + _prior_energy(
            delta, base.HM, base.bM0, base.prior_diag)

    frames, calib = base.frames, base.calib
    points = tuple(p.points for p in S.parts)
    pmasks = tuple(p.mask for p in points)
    lin0 = lin_at(frames, points, calib)
    photo_energy = S.sum(torch.sum(ln.energy) for ln in lin0)
    energy = total_energy(frames, calib, photo_energy)
    sys = ba_solve.accumulate_shards(lin0, [p.host for p in points], F,
                                     S.sh)
    lam = torch.tensor(1e-4, device=energy.device)
    n_pts = torch.clamp(S.sum(torch.sum(m.to(torch.float32))
                              for m in pmasks), min=1.0)
    it = 0
    while it < max_iters:
        delta = ba_solve.state_delta(frames, calib, base.calib0)
        bM_eff = base.bM0 + base.HM @ delta
        b_prior = base.prior_diag * delta
        dx, dxd = ba_solve.solve_levenberg(
            sys, base.HM, bM_eff, base.prior_diag, b_prior, lam,
            frames.mask, pmasks, N_null, shards=S.sh)
        frames_n, calib_n = _apply_step(frames, calib, dx, F)
        points_n = tuple(_step_points(p, d) for p, d in zip(points, dxd))
        lin_n = lin_at(frames_n, points_n, calib_n)
        photo_n = S.sum(torch.sum(ln.energy) for ln in lin_n)
        e_n = total_energy(frames_n, calib_n, photo_n)
        accept = (e_n < energy) & torch.isfinite(e_n)
        step_sq = torch.sum(dx * dx) \
            + S.sum(torch.sum(d * d) for d in dxd) / n_pts
        rel_impr = (energy - e_n) / torch.clamp(energy, min=1e-12)
        converged = (step_sq < 1e-10) | (torch.abs(rel_impr) < 2e-4)
        sys_n = ba_solve.accumulate_shards(
            lin_n, [p.host for p in points_n], F, S.sh)
        frames = _select(accept, frames_n, frames)
        points = _select(accept, points_n, points)
        calib = _select(accept, calib_n, calib)
        sys = _select(accept, sys_n, sys)
        energy = torch.where(accept, e_n, energy)
        photo_energy = torch.where(accept, photo_n, photo_energy)
        done = (converged & (it + 1 >= MIN_BA_ITERS)) | (lam > 1e3)
        lam = torch.where(accept, torch.clamp(lam * 0.25, min=1e-6),
                          lam * 4.0)
        it += 1
        if bool(done):          # the one host read per LM iteration
            break

    # Outlier classification on the final linearization, with the
    # adaptive per-frame threshold (the looser of host and target).
    lin_f = lin_at(frames, points, calib)
    return _classify(S, frames, points, calib, lin_f, photo_energy, it,
                     BAResult)


def _classify(S: _Shards, frames, points, calib, lin_f, photo_energy, it,
              result, **extra):
    """Whole results of a window solve: the final linearization gathered,
    the per-frame threshold on it and the outlier pairs (against the
    problem's own incidence and point mask)."""
    energy = S.whole((ln.energy for ln in lin_f), 1)
    oob = S.whole((ln.oob for ln in lin_f), 1)
    pair_ok = S.whole((p.pair_mask for p in S.parts), 1) \
        & S.whole(p.points.mask for p in S.parts)[None, :]
    host0 = S.whole(p.points.host for p in S.parts)
    frame_th = frame_energy_th(energy, pair_ok)
    th_pair = torch.maximum(frame_th[:, None],
                            frame_th[host0.long()][None, :])
    outlier = pair_ok & ((energy > th_pair) | oob)
    fields = dict(
        frames=frames, points=S.whole_points(points), calib=calib,
        energy=photo_energy, iters=torch.tensor(it), pair_outlier=outlier,
        pair_oob=oob, pair_energy=energy, frame_th=frame_th, **extra)
    for k in ("idepth_new", "u_new", "v_new"):
        if k in result._fields:
            fields[k] = S.whole((getattr(ln, k) for ln in lin_f), 1)
    return result(**{k: fields[k] for k in result._fields})


def marginalization_update(problem: BAProblem, images: torch.Tensor,
                           marg_points: torch.Tensor):
    """(HM, bM0) increment for the points being marginalized: each shard
    folds its own points, the increments are summed across shards."""
    S = _Shards(problem, images)
    marg = dist_ba.parts_of(marg_points, S.sh)
    F = S.parts[0].frames.mask.shape[0]
    lins = S.linearize(S.parts[0].frames, [p.points for p in S.parts],
                       S.parts[0].calib)
    incs = []
    for p, ln, m in zip(S.parts, lins, marg):
        delta = ba_solve.state_delta(p.frames, p.calib, p.calib0)
        pts = p.points
        delta_d = torch.where(pts.mask, pts.idepth - pts.idepth_zero,
                              torch.zeros_like(pts.idepth))
        incs.append(ba_solve.marginalize_points_system(
            ln, pts.host, delta, delta_d, m, F))
    return S.sum(h for h, _ in incs), S.sum(b for _, b in incs)


def select_victims(frames: BAFrames, age_rank: torch.Tensor,
                   n_drop, newest_slot: int) -> torch.Tensor:
    """Marginalization victims (flagFramesForMarginalization distance
    heuristic): the n_drop eligible frames with the smallest score, padded
    with -1 to [F]. Eligible = occupied and not among the two newest."""
    F = frames.mask.shape[0]
    dev = frames.mask.device
    occ = frames.mask
    t = frames.t_cw
    diff = t[:, None, :] - t[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    ar = torch.arange(F, device=dev)
    off_diag = ar[:, None] != ar[None, :]
    inv = torch.where(occ[None, :] & off_diag, 1.0 / (1e-5 + dist),
                      torch.zeros_like(dist))
    score = -torch.sqrt(dist[:, newest_slot]) * torch.sum(inv, dim=1)
    n_occ = torch.sum(occ.to(torch.int32))
    eligible = occ & (age_rank >= 0) & (age_rank < n_occ - 2)
    order = torch.sort(torch.where(eligible, score,
                                   torch.full_like(score, float("inf"))),
                       stable=True).indices
    return torch.where(ar < n_drop, order, torch.full_like(order, -1))


def marg_fused(problem: BAProblem, images: torch.Tensor,
               age_rank: torch.Tensor, n_drop, newest_slot: int):
    """Victim selection + point-marginalization fold + point drop.

    Returns (vlist [F], HM_add, bM_add, points_new, pair_mask_new,
    n_active_pre, n_active_post)."""
    S = _Shards(problem, images)
    vlist = select_victims(S.parts[0].frames, age_rank, n_drop, newest_slot)
    vls = S.sh.copies(vlist)
    masks = [window_ops.victims_masks(p.points, p.pair_mask, v)
             for p, v in zip(S.parts, vls)]
    HM_add, bM_add = marginalization_update(
        problem, images, _replaced(problem, [m[1] for m in masks]))
    n_pre = S.sum(torch.sum(p.points.mask.to(torch.float32))
                  for p in S.parts)
    drops = [window_ops.drop_points_mask(p.points, pm, hosted)
             for p, (hosted, _, pm) in zip(S.parts, masks)]
    n_post = S.sum(torch.sum(pts.mask.to(torch.float32))
                   for pts, _ in drops)
    return (vlist, HM_add, bM_add, S.whole_points([d[0] for d in drops]),
            S.whole((d[1] for d in drops), 1), n_pre, n_post)


def _replaced(like, parts):
    """Per-shard `parts` placed as `like` is (plain when unsharded)."""
    if isinstance(like, dist_ba.Placed):
        return dist_ba.Placed(parts, like.placer)
    return parts[0]
