"""Coarse-to-fine direct image alignment tracker.

Counterpart of dmvio_tpu/models/coarse_tracker.py (trackNewestCoarse and
makeCoarseDepthL0), with its IMU prior: given a `CoarsePrior`, every
level's LM is the joint visual + inertial 17-dof solve (trackNewestCoarse
+ computeCoarseUpdate). The reference vmaps the whole
coarse-to-fine LM over the candidate ladder and runs each level as a
`while_loop`; here the candidates are an explicit batch axis B and each
level is a Python loop whose per-candidate updates are gated by
`active = (it < max_it) & ~done`, ending when no candidate is active.

The packed stats row and its host view `PackedTrack` keep the reference's
layout (coarse_tracker.py:345-351), so the host logic ports line for line.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dmvio_tpu_torch.ops import align, interp
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib, PYR_LEVELS

MAX_ITERS = (10, 20, 50, 50, 50, 50)
HUBER_TH = 9.0
CUTOFF_TH = 20.0
PRIOR_RHO = 50.0
PRIOR_B = 0.05
# Photometric noise weight tying tracker units to the prior's Mahalanobis
# units (see models/vio_ba.W_DSO).
W_PHOTO = 1.0 / 64.0


class CoarsePrior(NamedTuple):
    """Gaussian prior fused into the per-level joint solve (the IMU side of
    CoarseIMULogic::computeCoarseUpdate). Coordinates [17]: [xi(6) left-inc
    on the TRACKED pose, aff(2), v(3), bias(6)]; `H` is information in the
    VIO (Mahalanobis) units; the centres define the zero-delta point, the
    pose centre relative to the tracking reference."""

    H: torch.Tensor       # [17, 17]
    R0: torch.Tensor      # [3, 3]
    t0: torch.Tensor      # [3]
    aff0: torch.Tensor    # [2]
    v0: torch.Tensor      # [3]
    b0: torch.Tensor      # [6]


class TrackerRef(NamedTuple):
    """Reference keyframe data for tracking: pyramid + per-level clouds."""

    pyr: tuple     # tuple of [3, H_l, W_l] tensors
    clouds: tuple  # tuple of align.PointCloud per level


class TrackResult(NamedTuple):
    R: torch.Tensor            # ref -> new rotation
    t: torch.Tensor            # ref -> new translation
    rho: torch.Tensor          # relative log brightness gain
    b_aff: torch.Tensor        # relative brightness offset
    v: torch.Tensor            # [3] velocity (zero without an IMU prior)
    bias: torch.Tensor         # [6] IMU bias (zero without an IMU prior)
    H_vis: torch.Tensor        # [8,8] finest-level Hessian * W_PHOTO
    level_energy: torch.Tensor  # [L] final mean energy per level (fine = 0)
    level_terms: torch.Tensor   # [L] term counts
    flow_t: torch.Tensor
    flow_rt: torch.Tensor
    valid: torch.Tensor         # bool: finite results and enough terms


def make_tracker_ref(ref_pyr: Sequence[torch.Tensor], calib0: Calib,
                     u0, v0, idepth, mask) -> TrackerRef:
    """Per-level reference clouds (u, v, idepth, color, mask) from
    level-0 points."""
    clouds = []
    for l, lvl in enumerate(ref_pyr):
        s = 0.5 ** l
        ul = (u0 + 0.5) * s - 0.5
        vl = (v0 + 0.5) * s - 0.5
        h, w = lvl.shape[-2:]
        m = mask & interp.in_bounds(ul, vl, h, w, pad=2.0) & (idepth > 0)
        color = interp.bilinear(lvl[0], ul, vl)
        clouds.append(align.PointCloud(u=ul, v=vl, idepth=idepth,
                                       color=color, mask=m))
    return TrackerRef(pyr=tuple(ref_pyr), clouds=tuple(clouds))


class _LMState(NamedTuple):
    R: torch.Tensor       # [B, 3, 3]
    t: torch.Tensor       # [B, 3]
    rho: torch.Tensor     # [B]
    b_aff: torch.Tensor   # [B]
    v: torch.Tensor       # [B, 3]
    bias: torch.Tensor    # [B, 6]
    lam: torch.Tensor
    energy: torch.Tensor  # mean energy at the current accepted state
    terms: torch.Tensor
    H: torch.Tensor       # [B, 8, 8] GN system at the current state
    b: torch.Tensor       # [B, 8]
    it: torch.Tensor      # [B] int32
    done: torch.Tensor    # [B] bool


def _sel(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _prior_delta(pr: CoarsePrior, R, t, rho, b_aff, v, bias):
    """[B, 17] offsets of B tracker states from the prior's centre."""
    Ri, ti = lie.se3_inv(pr.R0, pr.t0)
    xi = lie.se3_log(*lie.se3_mul(R, t, Ri, ti))
    return torch.cat([xi, torch.stack([rho, b_aff], dim=-1) - pr.aff0,
                      v - pr.v0, bias - pr.b0], dim=-1)


def _prior_quad(pr: CoarsePrior, d):
    """(d^T H d, H d) of B prior offsets d [B, 17]."""
    Hd = d @ pr.H.T
    return torch.sum(d * Hd, dim=-1), Hd


def _track_level(tgt_level, calib_l, pc, R0, t0, rho0, b0, max_it: int,
                 prior: Optional[CoarsePrior] = None, v0=None,
                 bias0=None) -> _LMState:
    """LM on one pyramid level for B candidates, optionally fused with a
    17-dof Gaussian prior (v0 [B, 3], bias0 [B, 6] start the inertial
    part). One sampling pass per iteration: a trial's GN system is kept for
    the next solve if accepted."""
    dev = R0.device
    B = R0.shape[0]

    def eval_state(R, t, rho, b, v, bias, cmult, terms_hint):
        H, bvec, stats = align.calc_res_and_gs(
            tgt_level, calib_l, pc, R, t, torch.exp(rho), b,
            HUBER_TH, CUTOFF_TH, cmult)
        n = stats.num_terms
        em = stats.energy / torch.clamp(n, min=1.0)
        if prior is not None:
            # Prior energy in mean-photometric units (the joint system is
            # solved in mean units).
            d = _prior_delta(prior, R, t, rho, b, v, bias)
            hint = n if terms_hint is None else terms_hint
            em = em + _prior_quad(prior, d)[0] \
                / (W_PHOTO * torch.clamp(hint, min=1.0))
        return H, bvec, em, n

    # Cutoff escalation (levelCutoffRepeat), all ratios from one pass.
    ratios = align.calc_sat_profile(tgt_level, calib_l, pc, R0, t0,
                                    torch.exp(rho0), b0, CUTOFF_TH)
    one = torch.ones(B, device=dev)
    cmult = torch.where(ratios[:, 0] <= 0.6, one,
                        torch.where(ratios[:, 1] <= 0.6, 2.0 * one,
                                    torch.where(ratios[:, 2] <= 0.6,
                                                4.0 * one, 8.0 * one)))
    if v0 is None:
        v0 = torch.zeros(B, 3, device=dev)
    if bias0 is None:
        bias0 = torch.zeros(B, 6, device=dev)
    H0, b0_vec, e0, n0 = eval_state(R0, t0, rho0, b0, v0, bias0, cmult,
                                    None)
    st = _LMState(R=R0, t=t0, rho=rho0, b_aff=b0, v=v0, bias=bias0,
                  lam=torch.full((B,), 0.01, device=dev), energy=e0,
                  terms=n0, H=H0, b=b0_vec,
                  it=torch.zeros(B, dtype=torch.int32, device=dev),
                  done=n0 < 20.0)
    reg = torch.tensor([0, 0, 0, 0, 0, 0, PRIOR_RHO, PRIOR_B], device=dev)
    eye8 = torch.eye(8, device=dev)
    while True:
        active = (st.it < max_it) & ~st.done
        if not bool(active.any()):
            return st
        nrm = torch.clamp(st.terms, min=1.0)[:, None]
        Hs = st.H / nrm[..., None] + torch.diag(reg)
        zeros6 = torch.zeros(B, 6, device=dev)
        bs = st.b / nrm + reg * torch.cat(
            [zeros6, st.rho[:, None], st.b_aff[:, None]], dim=1)
        if prior is None:
            Hl = Hs + st.lam[:, None, None] * torch.diag_embed(
                torch.diagonal(Hs, dim1=-2, dim2=-1)) + 1e-8 * eye8
            step8 = torch.linalg.solve_ex(Hl, -bs)[0]
            step8 = torch.where(torch.isfinite(step8), step8,
                                torch.zeros_like(step8))
            vn, biasn = st.v, st.bias
        else:
            # Joint 17-dof solve in mean-photometric units: the prior H is
            # divided by (W_PHOTO * terms) to match.
            scale = 1.0 / (W_PHOTO * nrm)
            d = _prior_delta(prior, st.R, st.t, st.rho, st.b_aff, st.v,
                             st.bias)
            H17 = torch.zeros(B, 17, 17, device=dev)
            H17[:, :8, :8] = Hs
            b17 = torch.zeros(B, 17, device=dev)
            b17[:, :8] = bs
            H17 = H17 + prior.H * scale[..., None]
            b17 = b17 + _prior_quad(prior, d)[1] * scale
            Hl = H17 + st.lam[:, None, None] * torch.diag_embed(
                torch.diagonal(H17, dim1=-2, dim2=-1)) \
                + 1e-8 * torch.eye(17, device=dev)
            step = torch.linalg.solve_ex(Hl, -b17)[0]
            step = torch.where(torch.isfinite(step), step,
                               torch.zeros_like(step))
            step8 = step[:, :8]
            vn = st.v + step[:, 8:11]
            biasn = st.bias + step[:, 11:17]
        Rn, tn = lie.se3_retract(st.R, st.t, step8[:, :6])
        # Hard bounds on the brightness pair: under a conflicting prior the
        # affine DOFs are the escape valve and can run away to overflow.
        rhon = torch.clamp(st.rho + step8[:, 6], -2.0, 2.0)
        bn = torch.clamp(st.b_aff + step8[:, 7], -80.0, 80.0)
        Hn, bn_vec, en, nn = eval_state(Rn, tn, rhon, bn, vn, biasn, cmult,
                                        st.terms)
        accept = (en < st.energy) & torch.isfinite(en)
        small = torch.sum(step8 * step8, dim=1) < 1e-6
        flat = accept & (torch.abs(en - st.energy)
                         < 2e-4 * torch.clamp(st.energy, min=1e-12))
        new = _LMState(
            R=_sel(accept, Rn, st.R), t=_sel(accept, tn, st.t),
            rho=_sel(accept, rhon, st.rho), b_aff=_sel(accept, bn, st.b_aff),
            v=_sel(accept, vn, st.v), bias=_sel(accept, biasn, st.bias),
            lam=torch.where(accept, torch.clamp(st.lam * 0.25, min=1e-6),
                            st.lam * 4.0),
            energy=_sel(accept, en, st.energy),
            terms=_sel(accept, nn, st.terms),
            H=_sel(accept, Hn, st.H), b=_sel(accept, bn_vec, st.b),
            it=st.it + 1,
            done=small | flat | (st.lam > 1e4))
        st = _LMState(*(_sel(active, a, b) for a, b in zip(new, st)))


def track_batch(ref: TrackerRef, new_pyr, calib0: Calib, R_init, t_init,
                rho_init, b_init, levels: int = PYR_LEVELS,
                prior: Optional[CoarsePrior] = None, v_init=None,
                bias_init=None):
    """Coarse-to-fine track of B initializations: (TrackResult with a
    leading B axis, packed [B, 25 + 2L + 1 + 64]). With `prior`, each
    level's LM is the joint 17-dof solve, started from v_init [3] and
    bias_init [6] (zeros when None)."""
    B = R_init.shape[0]
    dev = R_init.device
    R, t = R_init, t_init
    rho = rho_init.expand(B).clone()
    b_aff = b_init.expand(B).clone()
    v = torch.zeros(B, 3, device=dev) if v_init is None \
        else v_init.expand(B, 3).clone()
    bias = torch.zeros(B, 6, device=dev) if bias_init is None \
        else bias_init.expand(B, 6).clone()
    level_energy, level_terms = [], []
    for lvl in range(levels - 1, -1, -1):
        st = _track_level(new_pyr[lvl], calib0.at_level(lvl),
                          ref.clouds[lvl], R, t, rho, b_aff,
                          MAX_ITERS[min(lvl, len(MAX_ITERS) - 1)],
                          prior=prior, v0=v, bias0=bias)
        R, t, rho, b_aff = st.R, st.t, st.rho, st.b_aff
        v, bias = st.v, st.bias
        level_energy.append(st.energy)
        level_terms.append(st.terms)
    level_energy = torch.stack(level_energy[::-1], dim=1)   # [B, L], 0 = fine
    level_terms = torch.stack(level_terms[::-1], dim=1)

    H_fin, _, stats = align.calc_res_and_gs(
        new_pyr[0], calib0, ref.clouds[0], R, t, torch.exp(rho), b_aff,
        HUBER_TH, CUTOFF_TH, 1.0)
    finite = (torch.all(torch.isfinite(level_energy), dim=1)
              & torch.all(torch.isfinite(t), dim=1)
              & torch.all(torch.isfinite(R.reshape(B, 9)), dim=1))
    enough = level_terms[:, 0] > 10.0
    pose_info = torch.diagonal(H_fin[:, :6, :6], dim1=-2, dim2=-1).sum(-1) \
        / torch.clamp(level_terms[:, 0], min=1.0)
    valid = finite & enough & (pose_info > 1e-3)
    packed = torch.cat([
        R.reshape(B, 9), t, rho[:, None], b_aff[:, None], v, bias,  # 0:23
        torch.stack([stats.flow_t, stats.flow_rt], dim=1),          # 23:25
        level_energy, level_terms,                                  # 25:25+2L
        valid.to(torch.float32)[:, None],                           # 25+2L
        (H_fin * W_PHOTO).reshape(B, 64),                           # +1:+65
    ], dim=1)
    res = TrackResult(
        R=R, t=t, rho=rho, b_aff=b_aff, v=v, bias=bias,
        H_vis=H_fin * W_PHOTO, level_energy=level_energy,
        level_terms=level_terms, flow_t=stats.flow_t,
        flow_rt=stats.flow_rt, valid=valid)
    return res, packed


def track(ref: TrackerRef, new_pyr, calib0: Calib, R_init, t_init,
          rho_init, b_init, levels: int = PYR_LEVELS,
          prior: Optional[CoarsePrior] = None, v_init=None, bias_init=None):
    """Track one initialization: (TrackResult, packed [25 + 2L + 65])."""
    res, packed = track_batch(ref, new_pyr, calib0, R_init[None],
                              t_init[None], rho_init, b_init, levels,
                              prior, v_init, bias_init)
    return TrackResult(*(x[0] for x in res)), packed[0]


def track_multi(ref: TrackerRef, new_pyr, calib0: Calib, R_cands, t_cands,
                cand_mask, rho_init, b_init, energy_gate,
                levels: int = PYR_LEVELS,
                prior: Optional[CoarsePrior] = None, v_init=None,
                bias_init=None):
    """Track every candidate initialization and pick the winner on the
    device: the first candidate beating `energy_gate`, else the best valid
    one by finest-level energy. Returns (TrackResult of the winner,
    packed [D + 2]) with (winner index, any-valid flag) appended."""
    res, packed = track_batch(ref, new_pyr, calib0, R_cands, t_cands,
                              rho_init, b_init, levels, prior, v_init,
                              bias_init)
    L = levels
    e0 = packed[:, 25]
    validc = (packed[:, 25 + 2 * L] > 0.5) & cand_mask
    e_eff = torch.where(validc, e0, torch.full_like(e0, float("inf")))
    passes = validc & (e0 < energy_gate)
    # argmax of the int-cast mask = first passing candidate; argmin takes
    # the first minimum, as jnp.argmax/argmin do.
    sel = torch.where(passes.any(), torch.argmax(passes.to(torch.int32)),
                      torch.argmin(e_eff))
    sel_res = TrackResult(*(x[sel] for x in res))
    sel_packed = torch.cat([packed[sel], sel.to(torch.float32)[None],
                            validc.any().to(torch.float32)[None]])
    return sel_res, sel_packed


class PackedTrack:
    """Host-side view of the packed tracker stats array."""

    def __init__(self, arr, levels: int):
        a = np.asarray(arr)
        self.R = a[0:9].reshape(3, 3)
        self.t = a[9:12]
        self.rho = float(a[12])
        self.b_aff = float(a[13])
        self.v = a[14:17]
        self.bias = a[17:23]
        self.flow_t = float(a[23])
        self.flow_rt = float(a[24])
        L = levels
        self.level_energy = a[25:25 + L]
        self.level_terms = a[25 + L:25 + 2 * L]
        self.valid = a[25 + 2 * L] > 0.5
        self.H_vis = a[26 + 2 * L:26 + 2 * L + 64].reshape(8, 8)
        if a.shape[0] >= 26 + 2 * L + 64 + 2:
            self.sel = int(a[26 + 2 * L + 64])
            self.any_valid = a[26 + 2 * L + 64 + 1] > 0.5
        else:
            self.sel = 0
            self.any_valid = self.valid
        # A diverged solve (non-finite pose, non-orthonormal rotation, or an
        # absurd translation) reads as LOST, never as a valid track.
        with np.errstate(all="ignore"):
            finite = bool(np.all(np.isfinite(a[0:25])))
            if finite:
                finite = bool(abs(self.R[0] @ self.R[0] - 1.0) < 0.1)
            if finite:
                finite = bool(np.linalg.norm(self.t) < 1e3)
        if not finite:
            self.valid = False
            self.any_valid = False
