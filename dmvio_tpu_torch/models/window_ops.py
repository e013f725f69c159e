"""Device-side window bookkeeping ops.

Counterpart of dmvio_tpu/models/window_ops.py: point admission into free
slots, immature respawn with eviction, post-BA outlier pruning, the
marginalization mask plumbing and the realtime pipeline's device-side
tracking candidates, all as tensor ops with static shapes and exact
masking. Updates are functional (clone, then
assign): the keyframe path keeps snapshots of the window to revert a
diverged BA, so no op mutates its inputs.

Slot matching: a stable sort puts free slots first and candidates
best-first; the rank-r candidate goes to the rank-r free slot.
"""

from __future__ import annotations

import torch

from dmvio_tpu_torch.ops import immature, interp, select
from dmvio_tpu_torch.ops.immature import (IPS_GOOD, IPS_OOB, IPS_OUTLIER,
                                          IPS_SKIPPED, IPS_UNINITIALIZED,
                                          IDEPTH_MAX_INIT, MIN_TRACE_QUALITY,
                                          ImmaturePoints)
from dmvio_tpu_torch.ops.residuals import BAFrames, BAPoints
from dmvio_tpu_torch.utils.camera import pattern


def _argsort(x: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (jnp.argsort semantics)."""
    return torch.sort(x, stable=True).indices


def _set(arr: torch.Tensor, idx, vals) -> torch.Tensor:
    # Clone, never write in place: snapshots of the window rely on it, and
    # so does parallel/dist_ba.Placer, which caches its copies of the image
    # stack by the stack tensor's identity.
    out = arr.clone()
    out[idx] = vals
    return out


def project_into(frames: BAFrames, host, u, v, idepth, calib, slot: int):
    """Project per-point host pixels into window frame `slot`:
    (u', v', idepth', valid)."""
    host = host.long()
    R_h = frames.R_cw[host]
    t_h = frames.t_cw[host]
    R_th = torch.einsum("ij,pkj->pik", frames.R_cw[slot], R_h)
    t_th = frames.t_cw[slot][None] - torch.einsum("pij,pj->pi", R_th, t_h)
    xr = (u - calib.cx) / calib.fx
    yr = (v - calib.cy) / calib.fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    pt = torch.einsum("pij,pj->pi", R_th, ray) + t_th * idepth[:, None]
    pz = pt[..., 2]
    valid = pz > 1e-6
    pzs = torch.where(valid, pz, torch.ones_like(pz))
    un = pt[..., 0] / pzs * calib.fx + calib.cx
    vn = pt[..., 1] / pzs * calib.fy + calib.cy
    return un, vn, idepth / pzs, valid


def pattern_colors(level0, u, v):
    """Host pattern intensities + gradient weights at new point locations."""
    pat = pattern(u.device)
    samp = interp.bilinear_stack(level0, u[:, None] + pat[:, 0],
                                 v[:, None] + pat[:, 1])
    g2 = samp[..., 1] ** 2 + samp[..., 2] ** 2
    return samp[..., 0], torch.sqrt(2500.0 / (2500.0 + g2))


def insert_frame(frames: BAFrames, images, pair_mask, points_mask,
                 slot: int, pyr0, R_cw, t_cw, aff):
    """Occupy a frame slot; the new frame observes all active points."""
    f = frames._replace(
        R_cw=_set(frames.R_cw, slot, R_cw), t_cw=_set(frames.t_cw, slot, t_cw),
        aff=_set(frames.aff, slot, aff), R0_cw=_set(frames.R0_cw, slot, R_cw),
        t0_cw=_set(frames.t0_cw, slot, t_cw),
        aff0=_set(frames.aff0, slot, aff),
        mask=_set(frames.mask, slot, True))
    return f, _set(images, slot, pyr0), _set(pair_mask, slot, points_mask)


def set_fej_current(frames: BAFrames, slot: int) -> BAFrames:
    return frames._replace(
        R0_cw=_set(frames.R0_cw, slot, frames.R_cw[slot]),
        t0_cw=_set(frames.t0_cw, slot, frames.t_cw[slot]),
        aff0=_set(frames.aff0, slot, frames.aff[slot]))


def admit_points(points: BAPoints, pair_mask, frames_mask, cand_host,
                 cand_u, cand_v, cand_idepth, cand_color, cand_weight,
                 cand_ok, cand_score):
    """Admit candidates into free point slots, best score first.

    Returns (points, pair_mask, admitted [I] bool)."""
    P = points.mask.shape[0]
    I = cand_ok.shape[0]
    F = frames_mask.shape[0]
    K = min(P, I)
    dev = points.mask.device
    free = ~points.mask
    slot_order = _argsort((~free).to(torch.int32))      # free slots first
    score = torch.where(cand_ok, cand_score,
                        torch.full_like(cand_score, float("-inf")))
    cand_order = _argsort(-score)
    n_admit = torch.minimum(torch.sum(free), torch.sum(cand_ok))
    adm = torch.arange(K, device=dev) < n_admit
    dest = slot_order[:K]
    src = cand_order[:K]

    def put(arr, vals):
        a = adm.reshape((K,) + (1,) * (vals.dim() - 1))
        return _set(arr, dest, torch.where(a, vals[src], arr[dest]))

    pts = points._replace(
        host=put(points.host, cand_host), u=put(points.u, cand_u),
        v=put(points.v, cand_v), idepth=put(points.idepth, cand_idepth),
        idepth_zero=put(points.idepth_zero, cand_idepth),
        color=put(points.color, cand_color),
        weight=put(points.weight, cand_weight),
        mask=_set(points.mask, dest, torch.where(adm, True,
                                                  points.mask[dest])))
    newcols = frames_mask[:, None] & (
        torch.arange(F, device=dev)[:, None] != cand_host[None, src])
    pm = pair_mask.clone()
    pm[:, dest] = torch.where(adm[None, :], newcols, pair_mask[:, dest])
    admitted = _set(torch.zeros(I, dtype=torch.bool, device=dev), src, adm)
    return pts, pm, admitted


def respawn_immatures(pool: ImmaturePoints, frames: BAFrames,
                      points: BAPoints, pyr0, calib, slot: int, h: int,
                      w: int) -> ImmaturePoints:
    """Select fresh candidates in the new KF and fill pool slots
    (makeNewTraces): free slots first, then evict OOB/OUTLIER slots."""
    I = pool.mask.shape[0]
    dev = pool.mask.device
    sel = select.select_points(pyr0, I, pot=4)
    au, av, _, avalid = project_into(frames, points.host, points.u, points.v,
                                     points.idepth, calib, slot)
    clear = select.occupancy_spacing(au, av, points.mask & avalid, sel.u,
                                     sel.v, h, w, radius=0, cell=4)
    ok = sel.mask & clear
    color, weight = pattern_colors(pyr0, sel.u, sel.v)

    dead = pool.mask & ((pool.status == IPS_OOB)
                        | (pool.status == IPS_OUTLIER))
    key = torch.where(~pool.mask, 0, torch.where(dead, 1, 2))
    slot_order = _argsort(key)
    cand_order = _argsort(-torch.where(
        ok, sel.score, torch.full_like(sel.score, float("-inf"))))
    n_admit = torch.minimum(torch.sum(key < 2), torch.sum(ok))
    adm = torch.arange(I, device=dev) < n_admit
    dest = slot_order
    src = cand_order

    def put(arr, vals):
        a = adm.reshape((I,) + (1,) * (vals.dim() - 1))
        return _set(arr, dest, torch.where(a, vals[src], arr[dest]))

    f32 = dict(dtype=torch.float32, device=dev)
    return pool._replace(
        host=put(pool.host, torch.full((I,), slot, dtype=torch.int32,
                                       device=dev)),
        u=put(pool.u, sel.u), v=put(pool.v, sel.v),
        idepth_min=put(pool.idepth_min, torch.zeros(I, **f32)),
        idepth_max=put(pool.idepth_max,
                       torch.full((I,), IDEPTH_MAX_INIT, **f32)),
        color=put(pool.color, color), weight=put(pool.weight, weight),
        quality=put(pool.quality, torch.full((I,), 1e4, **f32)),
        status=put(pool.status, torch.full((I,), IPS_UNINITIALIZED,
                                           dtype=torch.int32, device=dev)),
        mask=_set(pool.mask, dest, torch.where(adm, True, pool.mask[dest])))


def post_ba_update(points: BAPoints, pair_mask, outlier):
    """Drop outlier pairs, then points left without observations."""
    pm = pair_mask & ~outlier
    keep = points.mask & (torch.sum(pm, dim=0) > 0)
    return points._replace(mask=keep), pm & keep[None, :]


def victims_masks(points: BAPoints, pair_mask, vlist):
    """Masks for a -1-padded victim slot list: (hosted [P], marg_pts [P],
    pair_mask with victim rows cleared)."""
    host = points.host.long()
    is_victim_host = torch.any(host[None, :] == vlist[:, None], dim=0) & \
        (host >= 0)
    hosted = points.mask & is_victim_host
    marg_pts = hosted & (torch.sum(pair_mask, dim=0) >= 1)
    F = pair_mask.shape[0]
    row_victim = torch.any(torch.arange(F, device=vlist.device)[None, :]
                           == vlist[:, None], dim=0)
    return hosted, marg_pts, pair_mask & ~row_victim[:, None]


def drop_points_mask(points: BAPoints, pair_mask, drop):
    keep = points.mask & ~drop
    return points._replace(mask=keep), pair_mask & keep[None, :]


def drop_frame_slot(frames: BAFrames, pair_mask, slot: int):
    return (frames._replace(mask=_set(frames.mask, slot, False)),
            _set(pair_mask, slot, False))


def kf_pose_pack(frames: BAFrames) -> torch.Tensor:
    """All window poses + affine in one fetchable array [F*(9+3+2)]."""
    return torch.cat([frames.R_cw.reshape(-1), frames.t_cw.reshape(-1),
                      frames.aff.reshape(-1)])


def compose_abs_pose(R_rel, t_rel, rho, b_aff, frames: BAFrames, slot: int):
    """T_new_w = T_rel o T_ref and the absolute brightness pair."""
    R_ref = frames.R_cw[slot]
    t_ref = frames.t_cw[slot]
    aff_ref = frames.aff[slot]
    return (R_rel @ R_ref, R_rel @ t_ref + t_rel,
            torch.stack([aff_ref[0] + rho,
                         b_aff + torch.exp(rho) * aff_ref[1]]))


def track_candidates(R_last, t_last, R_prev, t_prev, frames: BAFrames,
                     slot: int):
    """Tracking candidate batch from the last two frames' device poses:
    [constant velocity, zero motion, identity at the reference, pad],
    relative to window frame `slot`. The realtime dispatch builds it on
    the device so that it never waits for a pose copy."""
    R_ref = frames.R_cw[slot]
    t_ref = frames.t_cw[slot]
    # Motion in the world frame, T_m = T_last o T_prev^-1, applied once
    # more for constant velocity.
    R_m = R_last @ R_prev.T
    t_m = t_last - R_m @ t_prev
    R_cv = R_m @ R_last
    t_cv = R_m @ t_last + t_m
    R1 = R_cv @ R_ref.T
    R2 = R_last @ R_ref.T
    eye = torch.eye(3, dtype=R1.dtype, device=R1.device)
    z = torch.zeros(3, dtype=t_cv.dtype, device=t_cv.device)
    R_c = torch.stack([R1, R2, eye, eye])
    t_c = torch.stack([t_cv - R1 @ t_ref, t_last - R2 @ t_ref, z, z])
    mask = torch.tensor([True, True, True, False], device=R1.device)
    return R_c, t_c, mask


def rel_candidates(R_cw, t_cw, frames: BAFrames, slot: int):
    """Candidates for an in-flight frame re-tracked against window frame
    `slot` (a reference whose pose has not reached the host): [the frame's
    own pose re-expressed, identity], padded to the fixed [4] batch."""
    R_rel = R_cw @ frames.R_cw[slot].T
    t_rel = t_cw - R_rel @ frames.t_cw[slot]
    eye = torch.eye(3, dtype=R_rel.dtype, device=R_rel.device)
    z = torch.zeros(3, dtype=t_rel.dtype, device=t_rel.device)
    R_c = torch.stack([R_rel, eye, R_rel, eye])
    t_c = torch.stack([t_rel, z, t_rel, z])
    mask = torch.tensor([True, True, False, False], device=R_rel.device)
    return R_c, t_c, mask


def activate_and_admit(pool: ImmaturePoints, frames: BAFrames,
                       points: BAPoints, pair_mask, images, calib,
                       slot: int, h: int, w: int, radius: int,
                       use_spacing: bool):
    """Candidate gating + spacing + idepth GN + admission
    (activatePointsMT). Returns (pool, points, pair_mask)."""
    d_mid = torch.clamp(
        0.5 * (pool.idepth_min + torch.clamp(pool.idepth_max, max=1e3)),
        1e-3, 50.0)
    tight = (pool.idepth_max - pool.idepth_min) < \
        torch.clamp(0.25 * d_mid, min=0.05)
    cand = pool.mask & ((pool.status == IPS_GOOD)
                        | (pool.status == IPS_SKIPPED)) & \
        (pool.quality > MIN_TRACE_QUALITY) & tight & (d_mid > 1e-3)
    cu, cv, _, cvalid = project_into(frames, pool.host, pool.u, pool.v,
                                     d_mid, calib, slot)
    if use_spacing:
        au, av, _, avalid = project_into(frames, points.host, points.u,
                                         points.v, points.idepth, calib,
                                         slot)
        cand = cand & select.occupancy_spacing(
            au, av, points.mask & avalid, cu, cv, h, w, radius=radius,
            cell=8)
    cand = cand & cvalid
    d, ok, _ = immature.activate(pool, cand, frames.R_cw, frames.t_cw,
                                 frames.aff, frames.mask, images, calib)
    pts, pm, _ = admit_points(points, pair_mask, frames.mask, pool.host,
                              pool.u, pool.v, d, pool.color, pool.weight,
                              ok & cand, pool.quality)
    # Every tried candidate leaves the pool (admitted or failed).
    return pool._replace(mask=pool.mask & ~cand), pts, pm
