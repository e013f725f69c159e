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


def frame_energy_th(pair_energy: torch.Tensor,
                    pair_ok: torch.Tensor) -> torch.Tensor:
    """Per-frame adaptive outlier threshold (setNewFrameEnergyTH): the
    0.7-quantile pair energy, blended with a constant floor and capped;
    12^2 * patternNum for frames without active pairs."""
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


def _prior_energy(delta, HM, bM0, prior_diag):
    return delta @ (2.0 * bM0 + HM @ delta) + delta @ (prior_diag * delta)


def _apply_step(frames: BAFrames, points: BAPoints, calib: Calib,
                dx, dxd, F: int):
    cal_new = Calib.from_vec(calib.as_vec() + dx[:4])
    fsteps = dx[4:].reshape(F, 8)
    R_new, t_new = lie.se3_retract(frames.R_cw, frames.t_cw, fsteps[:, :6])
    m = frames.mask
    aff_new = frames.aff + torch.where(m[:, None], fsteps[:, 6:8],
                                       torch.zeros_like(fsteps[:, 6:8]))
    R_new = torch.where(m[:, None, None], R_new, frames.R_cw)
    t_new = torch.where(m[:, None], t_new, frames.t_cw)
    id_new = torch.clamp(points.idepth + dxd, MIN_IDEPTH, MAX_IDEPTH)
    id_new = torch.where(points.mask, id_new, points.idepth)
    return (frames._replace(R_cw=R_new, t_cw=t_new, aff=aff_new),
            points._replace(idepth=id_new), cal_new)


def _select(accept, new, old):
    """Per-field torch.where(accept, new, old) over NamedTuples/Calib."""
    if isinstance(new, Calib):
        return Calib(*(torch.where(accept, getattr(new, f), getattr(old, f))
                       for f in ("fx", "fy", "cx", "cy")))
    return type(new)(*(torch.where(accept, a, b) for a, b in zip(new, old)))


def optimize(problem: BAProblem, images: torch.Tensor,
             max_iters: int = MAX_BA_ITERS,
             orthogonalize: bool = False) -> BAResult:
    """Run the windowed BA to (approximate) convergence.

    images [F, 3, H, W]: level-0 pyramids of the window frames.
    orthogonalize: project gauge directions out of each step (leave False
    when the gauge is pinned by priors, the default window setup)."""
    F = problem.frames.mask.shape[0]
    N_null = ba_solve.nullspaces(problem.frames, F) if orthogonalize \
        else None
    geo = residuals.fej_geometry(problem.frames, problem.points,
                                 problem.calib)

    def lin_at(frames, points, calib):
        return residuals.linearize(frames, points, calib, images,
                                   problem.pair_mask, geo=geo)

    def total_energy(frames, calib, lin):
        delta = ba_solve.state_delta(frames, calib, problem.calib0)
        return torch.sum(lin.energy) + _prior_energy(
            delta, problem.HM, problem.bM0, problem.prior_diag)

    frames, points, calib = problem.frames, problem.points, problem.calib
    lin0 = lin_at(frames, points, calib)
    energy = total_energy(frames, calib, lin0)
    photo_energy = torch.sum(lin0.energy)
    sys = ba_solve.accumulate(lin0, points.host, F)
    lam = torch.tensor(1e-4, device=energy.device)
    n_pts = torch.clamp(torch.sum(points.mask.to(torch.float32)), min=1.0)
    it = 0
    while it < max_iters:
        delta = ba_solve.state_delta(frames, calib, problem.calib0)
        bM_eff = problem.bM0 + problem.HM @ delta
        b_prior = problem.prior_diag * delta
        dx, dxd = ba_solve.solve_levenberg(
            sys, problem.HM, bM_eff, problem.prior_diag, b_prior, lam,
            frames.mask, points.mask, N_null)
        frames_n, points_n, calib_n = _apply_step(frames, points, calib,
                                                  dx, dxd, F)
        lin_n = lin_at(frames_n, points_n, calib_n)
        e_n = total_energy(frames_n, calib_n, lin_n)
        accept = (e_n < energy) & torch.isfinite(e_n)
        step_sq = torch.sum(dx * dx) + torch.sum(dxd * dxd) / n_pts
        rel_impr = (energy - e_n) / torch.clamp(energy, min=1e-12)
        converged = (step_sq < 1e-10) | (torch.abs(rel_impr) < 2e-4)
        sys_n = ba_solve.accumulate(lin_n, points_n.host, F)
        frames = _select(accept, frames_n, frames)
        points = _select(accept, points_n, points)
        calib = _select(accept, calib_n, calib)
        sys = _select(accept, sys_n, sys)
        energy = torch.where(accept, e_n, energy)
        photo_energy = torch.where(accept, torch.sum(lin_n.energy),
                                   photo_energy)
        done = (converged & (it + 1 >= MIN_BA_ITERS)) | (lam > 1e3)
        lam = torch.where(accept, torch.clamp(lam * 0.25, min=1e-6),
                          lam * 4.0)
        it += 1
        if bool(done):          # the one host read per LM iteration
            break

    # Outlier classification on the final linearization, with the
    # adaptive per-frame threshold (the looser of host and target).
    lin_f = lin_at(frames, points, calib)
    pair_ok = problem.pair_mask & problem.points.mask[None, :]
    frame_th = frame_energy_th(lin_f.energy, pair_ok)
    th_pair = torch.maximum(frame_th[:, None],
                            frame_th[problem.points.host.long()][None, :])
    outlier = pair_ok & ((lin_f.energy > th_pair) | lin_f.oob)
    return BAResult(
        frames=frames, points=points, calib=calib, energy=photo_energy,
        iters=torch.tensor(it), pair_outlier=outlier, pair_oob=lin_f.oob,
        pair_energy=lin_f.energy, idepth_new=lin_f.idepth_new,
        u_new=lin_f.u_new, v_new=lin_f.v_new, frame_th=frame_th)


def marginalization_update(problem: BAProblem, images: torch.Tensor,
                           marg_points: torch.Tensor):
    """(HM, bM0) increment for the points being marginalized."""
    F = problem.frames.mask.shape[0]
    lin = residuals.linearize(problem.frames, problem.points, problem.calib,
                              images, problem.pair_mask)
    delta = ba_solve.state_delta(problem.frames, problem.calib,
                                 problem.calib0)
    pts = problem.points
    delta_d = torch.where(pts.mask, pts.idepth - pts.idepth_zero,
                          torch.zeros_like(pts.idepth))
    return ba_solve.marginalize_points_system(lin, pts.host, delta, delta_d,
                                              marg_points, F)


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
    vlist = select_victims(problem.frames, age_rank, n_drop, newest_slot)
    hosted, marg_pts, pm_cleared = window_ops.victims_masks(
        problem.points, problem.pair_mask, vlist)
    HM_add, bM_add = marginalization_update(problem, images, marg_pts)
    n_pre = torch.sum(problem.points.mask.to(torch.float32))
    points_new, pm_new = window_ops.drop_points_mask(
        problem.points, pm_cleared, hosted)
    n_post = torch.sum(points_new.mask.to(torch.float32))
    return vlist, HM_add, bM_add, points_new, pm_new, n_pre, n_post
