"""Immature-point depth tracing and activation, fully batched.

Counterpart of dmvio_tpu/ops/immature.py (ImmaturePoint::traceOn: discrete
epipolar search + GN subpixel refinement; optimizeImmaturePoint:
idepth-only GN against all window frames). The whole pool is traced at
once; status codes follow ImmaturePointStatus.

The reference samples the discrete search through a one-hot matmul at the
TPU's default (bf16) precision; the port samples in exact float32, which
is also what the reference computes on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvio_tpu_torch.ops import interp, patch_sample
from dmvio_tpu_torch.utils.camera import Calib, pattern

IPS_UNINITIALIZED = 0
IPS_GOOD = 1
IPS_OOB = 2
IPS_OUTLIER = 3
IPS_SKIPPED = 4
IPS_BADCONDITION = 5

N_SAMPLES = 32
MAX_PIX_SEARCH = 0.08
TRACE_GN_ITERS = 3
OUTLIER_ENERGY = 12.0 * 12.0 * 8
MIN_TRACE_QUALITY = 3.0
IDEPTH_MAX_INIT = 1e8


class ImmaturePoints(NamedTuple):
    """SoA immature-point pool, fixed capacity I."""

    host: torch.Tensor        # [I] int32 host frame slot
    u: torch.Tensor           # [I]
    v: torch.Tensor           # [I]
    idepth_min: torch.Tensor  # [I]
    idepth_max: torch.Tensor  # [I]
    color: torch.Tensor       # [I, 8]
    weight: torch.Tensor      # [I, 8]
    quality: torch.Tensor     # [I] 2nd-best/best error ratio
    status: torch.Tensor      # [I] int32 IPS_*
    mask: torch.Tensor        # [I] bool slot in use


def empty_pool(capacity: int, device="cpu") -> ImmaturePoints:
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros(capacity, **f32)
    return ImmaturePoints(
        host=torch.zeros(capacity, dtype=torch.int32, device=device),
        u=z, v=z, idepth_min=z,
        idepth_max=torch.full((capacity,), IDEPTH_MAX_INIT, **f32),
        color=torch.zeros(capacity, 8, **f32),
        weight=torch.ones(capacity, 8, **f32),
        quality=torch.full((capacity,), 1e4, **f32),
        status=torch.zeros(capacity, dtype=torch.int32, device=device),
        mask=torch.zeros(capacity, dtype=torch.bool, device=device))


def _idepth_from_pixel(pr, t, x, y, use_x):
    """Host inverse depth projecting onto normalized coords (x, y), along
    the image axis with the larger epipolar motion."""
    dx = (pr[..., 0] - x * pr[..., 2]) / (x * t[..., 2] - t[..., 0])
    dy = (pr[..., 1] - y * pr[..., 2]) / (y * t[..., 2] - t[..., 1])
    return torch.where(use_x, dx, dy)


def trace(pool: ImmaturePoints, R_h, t_h, aff_h, R_n, t_n, aff_n,
          image_n, calib: Calib) -> ImmaturePoints:
    """Trace every pooled point against a new frame (level-0 [3, H, W]).

    R_h [I,3,3], t_h [I,3], aff_h [I,2]: host poses gathered per point;
    R_n, t_n, aff_n: the new frame's world-to-cam pose and affine."""
    h, w = image_n.shape[-2:]
    dev = pool.u.device
    max_search = MAX_PIX_SEARCH * (w + h)

    R_nh = torch.einsum("ij,pkj->pik", R_n, R_h)
    t_nh = t_n[None] - torch.einsum("pij,pj->pi", R_nh, t_h)
    xr = (pool.u - calib.cx) / calib.fx
    yr = (pool.v - calib.cy) / calib.fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    pr = torch.einsum("pij,pj->pi", R_nh, ray)

    def project_d(d):
        pt = pr + t_nh * d[:, None]
        pz = torch.where(torch.abs(pt[..., 2]) > 1e-6, pt[..., 2],
                         torch.full_like(pt[..., 2], 1e-6))
        x = pt[..., 0] / pz
        y = pt[..., 1] / pz
        return (x * calib.fx + calib.cx, y * calib.fy + calib.cy,
                pt[..., 2] > 1e-6)

    u_min, v_min, ok_min = project_d(pool.idepth_min)
    u_max, v_max, _ = project_d(torch.clamp(pool.idepth_max,
                                            max=IDEPTH_MAX_INIT))
    dirx = u_max - u_min
    diry = v_max - v_min
    dist = torch.sqrt(dirx * dirx + diry * diry)
    tiny = dist < 1.5
    dist_safe = torch.clamp(dist, min=1e-6)
    scale = torch.clamp(max_search / dist_safe, max=1.0)
    dirx_c = dirx * scale
    diry_c = diry * scale
    dist_c = dist_safe * torch.clamp(scale, max=1.0)

    pat = pattern(dev)
    pat_rot = torch.einsum("pij,kj->pki", R_nh[:, :2, :2], pat)  # [I, K, 2]
    rel_a = torch.exp(aff_n[0] - aff_h[:, 0])
    pred = rel_a[:, None] * (pool.color - aff_h[:, 1:2]) + aff_n[1]

    # Discrete search: S samples along the clipped epipolar segment.
    alphas = torch.linspace(0.0, 1.0, N_SAMPLES, device=dev)
    su = u_min[:, None] + alphas[None, :] * dirx_c[:, None]      # [I, S]
    sv = v_min[:, None] + alphas[None, :] * diry_c[:, None]
    pu = su[:, :, None] + pat_rot[:, None, :, 0]                 # [I, S, K]
    pv = sv[:, :, None] + pat_rot[:, None, :, 1]
    inb = interp.in_bounds(pu, pv, h, w, pad=3.0)
    i_s = interp.bilinear(image_n[0], pu, pv)
    err = torch.where(inb, (i_s - pred[:, None, :]) ** 2,
                      torch.full_like(i_s, 1e8))
    sample_e = torch.sum(err, dim=-1)
    sample_ok = torch.all(inb, dim=-1)
    inf = torch.full_like(sample_e, float("inf"))
    sample_e = torch.where(sample_ok, sample_e, inf)

    best = torch.argmin(sample_e, dim=-1)
    best_e = torch.amin(sample_e, dim=-1)
    best_ok = torch.gather(sample_ok, 1, best[:, None])[:, 0]
    step_px = dist_c / (N_SAMPLES - 1)
    sidx = torch.arange(N_SAMPLES, device=dev)[None, :]
    far = torch.abs(sidx - best[:, None]) * step_px[:, None] >= 2.0
    second_e = torch.amin(torch.where(far, sample_e, inf), dim=-1)
    quality = second_e / torch.clamp(best_e, min=1e-6)
    bu = torch.gather(su, 1, best[:, None])[:, 0]
    bv = torch.gather(sv, 1, best[:, None])[:, 0]

    # GN subpixel refinement along the epipolar direction.
    step_len = dist_c / (N_SAMPLES - 1)
    ndx = dirx_c / torch.clamp(dist_c, min=1e-6)
    ndy = diry_c / torch.clamp(dist_c, min=1e-6)
    for _ in range(TRACE_GN_ITERS):
        samp = interp.bilinear_stack(image_n, bu[:, None] + pat_rot[:, :, 0],
                                     bv[:, None] + pat_rot[:, :, 1])
        r = samp[..., 0] - pred
        gdir = samp[..., 1] * ndx[:, None] + samp[..., 2] * ndy[:, None]
        Hg = torch.sum(gdir * gdir, dim=-1) + 1e-6
        bg = torch.sum(gdir * r, dim=-1)
        step = torch.clamp(-bg / Hg, min=-step_len, max=step_len)
        bu = bu + step * ndx
        bv = bv + step * ndy

    pu = bu[:, None] + pat_rot[:, :, 0]
    pv = bv[:, None] + pat_rot[:, :, 1]
    inb_f = interp.in_bounds(pu, pv, h, w, pad=3.0)
    i_f = interp.bilinear(image_n[0], pu, pv)
    final_e = torch.sum(torch.where(inb_f, (i_f - pred) ** 2,
                                    torch.full_like(i_f, 1e8)), dim=-1)

    use_x = torch.abs(dirx_c) > torch.abs(diry_c)

    def idepth_at(uu, vv):
        x = (uu - calib.cx) / calib.fx
        y = (vv - calib.cy) / calib.fy
        return _idepth_from_pixel(pr, t_nh, x, y, use_x)

    d_a = idepth_at(bu - ndx, bv - ndy)
    d_b = idepth_at(bu + ndx, bv + ndy)
    new_min = torch.minimum(d_a, d_b)
    new_max = torch.maximum(d_a, d_b)

    searched = pool.mask & ~tiny & ok_min & torch.isfinite(bu) & \
        torch.isfinite(bv)
    good = searched & (final_e < OUTLIER_ENERGY) & (new_max > 0) & best_ok
    bad = searched & ~good
    new_min = torch.where(good, torch.clamp(new_min, min=0.0),
                          pool.idepth_min)
    new_max = torch.where(good, new_max, pool.idepth_max)
    quality_new = torch.where(good & (dist_c > 4.0), quality, pool.quality)
    st = pool.status
    status_new = torch.where(
        good, torch.full_like(st, IPS_GOOD),
        torch.where(tiny & pool.mask, torch.full_like(st, IPS_SKIPPED),
                    torch.where(bad, torch.full_like(st, IPS_OUTLIER), st)))
    return pool._replace(idepth_min=new_min, idepth_max=new_max,
                         quality=quality_new, status=status_new)


def activate(pool: ImmaturePoints, cand_mask, frames_R, frames_t,
             frames_aff, frames_mask, images, calib: Calib, iters: int = 4):
    """Idepth-only GN of every candidate against all window frames
    (optimizeImmaturePoint). images [F, 3, H, W]. Returns (idepth [I],
    ok [I], energy [I]). The pattern samples of every (target, point) pair
    come from kernel K1 (ops/patch_sample)."""
    h, w = images.shape[-2:]
    F = frames_mask.shape[0]
    dev = pool.u.device
    host = pool.host.long()
    Rh = frames_R[host]
    th = frames_t[host]
    aff_h = frames_aff[host]

    d0 = 0.5 * (pool.idepth_min + torch.clamp(pool.idepth_max, max=1e3))
    d0 = torch.clamp(d0, 1e-3, 50.0)
    pat = pattern(dev)
    up = pool.u[:, None] + pat[None, :, 0]
    vp = pool.v[:, None] + pat[None, :, 1]
    tgt_mask = (host[None, :] != torch.arange(F, device=dev)[:, None]) & \
        frames_mask[:, None] & cand_mask[None, :] & pool.mask[None, :]

    # Relative poses host -> every target [F, I], fixed across GN steps.
    R_th = torch.einsum("fij,pkj->fpik", frames_R, Rh)
    t_th = frames_t[:, None] - torch.einsum("fpij,pj->fpi", R_th, th)
    xr = (up - calib.cx) / calib.fx
    yr = (vp - calib.cy) / calib.fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)    # [I, K, 3]
    rot_ray = torch.einsum("fpij,pkj->fpki", R_th, ray)          # [F,I,K,3]
    rel_a = torch.exp(frames_aff[:, None, 0] - aff_h[None, :, 0])  # [F, I]
    pred = rel_a[..., None] * (pool.color - aff_h[:, 1:2])[None] + \
        frames_aff[:, None, None, 1]
    img0 = images[:, 0]

    def residuals_at(d):
        pt = rot_ray + t_th[:, :, None, :] * d[None, :, None, None]
        pz = torch.where(pt[..., 2] > 1e-6, pt[..., 2],
                         torch.full_like(pt[..., 2], 1e-6))
        x = pt[..., 0] / pz
        y = pt[..., 1] / pz
        un = x * calib.fx + calib.cx
        vn = y * calib.fy + calib.cy
        inb = interp.in_bounds(un, vn, h, w, pad=2.0) & (pt[..., 2] > 1e-6)
        i_s, gx, gy, okp = patch_sample.sample_patch3(img0, un, vn)
        r = i_s - pred
        tt = t_th[:, :, None, :]
        du_dd = calib.fx * (tt[..., 0] - tt[..., 2] * x) / pz
        dv_dd = calib.fy * (tt[..., 1] - tt[..., 2] * y) / pz
        Jdd = gx * du_dd + gy * dv_dd
        ok = inb & okp & tgt_mask[:, :, None]
        abs_r = torch.abs(r)
        hw = torch.where(abs_r < 9.0, torch.ones_like(r),
                         9.0 / torch.clamp(abs_r, min=1e-12))
        wt = torch.where(ok, hw, torch.zeros_like(hw))
        return r, Jdd, wt, ok

    d = d0
    for _ in range(iters):
        r, Jdd, wt, _ = residuals_at(d)
        Hd = torch.einsum("fpk,fpk->p", wt * Jdd, Jdd) + 1e-4
        bd = torch.einsum("fpk,fpk->p", wt * Jdd, r)
        step = torch.clamp(-bd / Hd, -0.5, 0.5)
        d = torch.clamp(d + step, 1e-3, 50.0)

    r, Jdd, wt, ok = residuals_at(d)
    e_pair = torch.sum(torch.where(ok, wt * r * r, torch.zeros_like(r)),
                       dim=-1)                                   # [F, I]
    good_pair = torch.any(ok, dim=-1) & (e_pair < OUTLIER_ENERGY)
    n_good = torch.sum(good_pair.to(torch.int32), dim=0)
    energy = torch.sum(torch.where(good_pair, e_pair,
                                   torch.zeros_like(e_pair)), dim=0)
    ok_point = cand_mask & pool.mask & (n_good >= 2) & (d > 1e-3) & \
        (d < 50.0)
    return d, ok_point, energy
