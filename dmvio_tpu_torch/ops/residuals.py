"""Batched photometric BA residual linearization.

Counterpart of dmvio_tpu/ops/residuals.py (PointFrameResidual::linearize
for every (target frame, point) pair of the window at once, with
First-Estimate-Jacobian discipline: geometric Jacobians at the frames'
linearization points and idepth_zero, residuals and image gradients at the
current state). The target axis F, which the reference vmaps, is written
out as the leading dimension.

State ordering of the BA stack: x = [calib(4) | frame 0: (xi(6), a, b) |
... | frame F-1], C = 4 + 8 F; pose increments are left-multiplicative on
world-to-cam poses. Brightness: predicted target intensity of a host pixel
with color c is exp(a_t - a_h) * (c - b_h) + b_t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvio_tpu_torch.ops import interp, patch_sample
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib, pattern

OUTLIER_TH_SUM_COMPONENT = 50.0 * 50.0
HUBER_TH = 9.0
OUTLIER_TH = 12.0 * 12.0


class BAFrames(NamedTuple):
    """SoA window frame state, fixed capacity F."""

    R_cw: torch.Tensor    # [F, 3, 3] current world-to-cam rotation
    t_cw: torch.Tensor    # [F, 3]
    aff: torch.Tensor     # [F, 2] brightness (a, b)
    R0_cw: torch.Tensor   # [F, 3, 3] linearization point (FEJ)
    t0_cw: torch.Tensor   # [F, 3]
    aff0: torch.Tensor    # [F, 2]
    mask: torch.Tensor    # [F] bool: slot occupied


class BAPoints(NamedTuple):
    """SoA active point state, fixed capacity P."""

    host: torch.Tensor          # [P] int32 host frame slot
    u: torch.Tensor             # [P] host pixel x (level 0)
    v: torch.Tensor             # [P] host pixel y
    idepth: torch.Tensor        # [P] current inverse depth (host frame)
    idepth_zero: torch.Tensor   # [P] linearization-point inverse depth
    color: torch.Tensor         # [P, 8] host pattern intensities
    weight: torch.Tensor        # [P, 8] host-gradient weights
    mask: torch.Tensor          # [P] bool: slot active


class BAResiduals(NamedTuple):
    """Dense linearization of all (target frame, point) pairs, [F, P, ...]."""

    r: torch.Tensor         # [F, P, K]
    wt: torch.Tensor        # [F, P, K]
    J_pose_t: torch.Tensor  # [F, P, K, 6]
    J_pose_h: torch.Tensor  # [F, P, K, 6]
    J_aff_t: torch.Tensor   # [F, P, K, 2]
    J_aff_h: torch.Tensor   # [F, P, K, 2]
    J_calib: torch.Tensor   # [F, P, K, 4]
    J_dd: torch.Tensor      # [F, P, K]
    active: torch.Tensor    # [F, P, K] bool
    energy: torch.Tensor    # [F, P]
    oob: torch.Tensor       # [F, P] bool
    u_new: torch.Tensor     # [F, P] warped central pixel (current state)
    v_new: torch.Tensor     # [F, P]
    idepth_new: torch.Tensor  # [F, P] inverse depth in the target frame


class FEJGeometry(NamedTuple):
    """Central-pixel geometric Jacobians at the FEJ state, [F, P, ...]."""

    J_uv_xi: torch.Tensor     # [F, P, 2, 6]
    J_uv_dd: torch.Tensor     # [F, P, 2]
    J_uv_calib: torch.Tensor  # [F, P, 2, 4]
    valid: torch.Tensor       # [F, P] bool
    adj0: torch.Tensor        # [F, P, 6, 6] adjoint of the FEJ T_th


def _relative(R_t, t_t, R_h, t_h):
    """T_th = T_t T_h^-1 for every (target f, point p): [F, P, 3, 3], [F, P, 3]."""
    R_th = torch.einsum("fij,pkj->fpik", R_t, R_h)
    t_th = t_t[:, None] - torch.einsum("fpij,pj->fpi", R_th, t_h)
    return R_th, t_th


def _project(calib: Calib, R, t, u, v, idepth):
    """Project host pixel (u, v, idepth) through relative pose (R, t).

    R [..., 3, 3] and t [..., 3] broadcast against u/v/idepth [..., (K)]
    by the caller. Returns (u', v', x, y, pz, d_new, valid)."""
    xr = (u - calib.cx) / calib.fx
    yr = (v - calib.cy) / calib.fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    pt = (R * ray.unsqueeze(-2)).sum(-1) + t * idepth[..., None]
    pz = pt[..., 2]
    valid = pz > 1e-6
    pz_safe = torch.where(valid, pz, torch.ones_like(pz))
    x = pt[..., 0] / pz_safe
    y = pt[..., 1] / pz_safe
    d_new = idepth / pz_safe
    return (x * calib.fx + calib.cx, y * calib.fy + calib.cy, x, y, pz_safe,
            d_new, valid)


def _geometric_jacobians(calib: Calib, R, t, u, v, idepth):
    """Central-pixel Jacobians of the warped pixel w.r.t. the relative-pose
    left increment, the host inverse depth and the intrinsics."""
    fx, fy, cx, cy = calib.fx, calib.fy, calib.cx, calib.cy
    xr = (u - cx) / fx
    yr = (v - cy) / fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)
    pt = (R * ray.unsqueeze(-2)).sum(-1) + t * idepth[..., None]
    pz = pt[..., 2]
    valid = pz > 1e-6
    pz = torch.where(valid, pz, torch.ones_like(pz))
    x = pt[..., 0] / pz
    y = pt[..., 1] / pz
    dn = idepth / pz
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * dn, zero, -fx * dn * x,
                      -fx * x * y, fx * (1.0 + x * x), -fx * y], dim=-1)
    Jv = torch.stack([zero, fy * dn, -fy * dn * y,
                      -fy * (1.0 + y * y), fy * x * y, fy * x], dim=-1)
    J_uv_xi = torch.stack([Ju, Jv], dim=-2)
    Jd = torch.stack([fx * (t[..., 0] - t[..., 2] * x) / pz,
                      fy * (t[..., 1] - t[..., 2] * y) / pz], dim=-1)

    def dpix_dpt(dpt):
        du = fx * (dpt[..., 0] - x * dpt[..., 2]) / pz
        dv = fy * (dpt[..., 1] - y * dpt[..., 2]) / pz
        return du, dv

    Rc0 = R[..., :, 0]
    Rc1 = R[..., :, 1]
    du_fx, dv_fx = dpix_dpt(-(xr / fx)[..., None] * Rc0)
    du_fy, dv_fy = dpix_dpt(-(yr / fy)[..., None] * Rc1)
    du_cx, dv_cx = dpix_dpt((-1.0 / fx) * Rc0)
    du_cy, dv_cy = dpix_dpt((-1.0 / fy) * Rc1)
    J_calib_u = torch.stack([x + du_fx, du_fy, one + du_cx, du_cy], dim=-1)
    J_calib_v = torch.stack([dv_fx, y + dv_fy, dv_cx, one + dv_cy], dim=-1)
    return J_uv_xi, Jd, torch.stack([J_calib_u, J_calib_v], dim=-2), valid


def fej_geometry(frames: BAFrames, points: BAPoints,
                 calib: Calib) -> FEJGeometry:
    """FEJ-state geometry shared by every LM iteration (hoisted out of the
    loop; the FEJ states do not move inside one window optimization)."""
    host = points.host.long()
    R_th0, t_th0 = _relative(frames.R0_cw, frames.t0_cw,
                             frames.R0_cw[host], frames.t0_cw[host])
    J_uv_xi, J_uv_dd, J_uv_calib, vz0 = _geometric_jacobians(
        calib, R_th0, t_th0, points.u, points.v, points.idepth_zero)
    return FEJGeometry(J_uv_xi, J_uv_dd, J_uv_calib, vz0,
                       lie.se3_adj(R_th0, t_th0))


def linearize(frames: BAFrames, points: BAPoints, calib: Calib,
              images: torch.Tensor, pair_mask: torch.Tensor,
              geo: FEJGeometry | None = None) -> BAResiduals:
    """Linearize every candidate photometric residual of the window.

    images [F, 3, H, W] level-0 (I, gx, gy); pair_mask [F, P]. The pattern
    samples of all pairs come from one launch of kernel K1."""
    h, w = images.shape[-2:]
    host = points.host.long()
    aff_h = frames.aff[host]                                   # [P, 2]
    pat = pattern(points.u.device)
    up = points.u[:, None] + pat[None, :, 0]                   # [P, K]
    vp = points.v[:, None] + pat[None, :, 1]
    if geo is None:
        geo = fej_geometry(frames, points, calib)

    R_th, t_th = _relative(frames.R_cw, frames.t_cw, frames.R_cw[host],
                           frames.t_cw[host])                  # [F, P, ...]
    dpat = points.idepth[:, None].expand(up.shape)
    un, vn, _, _, _, _, vz = _project(calib, R_th[:, :, None],
                                      t_th[:, :, None], up, vp, dpat)
    inb = interp.in_bounds(un, vn, h, w, pad=2.0) & vz         # [F, P, K]
    i_t, gx, gy, okp = patch_sample.sample_patch3(images[:, 0], un, vn)
    inb = inb & okp

    rel_a = torch.exp(frames.aff[:, None, 0] - aff_h[None, :, 0])   # [F, P]
    c_h = (points.color - aff_h[:, 1:2])[None]                      # [1,P,K]
    pred = rel_a[..., None] * c_h + frames.aff[:, None, None, 1]
    r = i_t - pred

    gw = torch.sqrt(OUTLIER_TH_SUM_COMPONENT
                    / (OUTLIER_TH_SUM_COMPONENT + gx * gx + gy * gy))
    wpx = 0.5 * (gw + points.weight[None])
    abs_wr = torch.abs(wpx * r)
    hw = torch.where(abs_wr < HUBER_TH, torch.ones_like(r),
                     HUBER_TH / torch.clamp(abs_wr, min=1e-12))
    wt = hw * wpx * wpx

    g = torch.stack([gx, gy], dim=-1)                          # [F, P, K, 2]
    Jr_xi_t = torch.einsum("fpkx,fpxd->fpkd", g, geo.J_uv_xi)
    Jr_dd = torch.einsum("fpkx,fpx->fpk", g, geo.J_uv_dd)
    Jr_cal = torch.einsum("fpkx,fpxd->fpkd", g, geo.J_uv_calib)
    Jr_xi_h = -torch.einsum("fpkd,fpde->fpke", Jr_xi_t, geo.adj0)

    d_at = -(rel_a[..., None] * c_h)                           # [F, P, K]
    J_aff_t = torch.stack([d_at, -torch.ones_like(d_at)], dim=-1)
    J_aff_h = torch.stack([-d_at, rel_a[..., None].expand(d_at.shape)],
                          dim=-1)

    pair_ok = pair_mask & points.mask[None]
    all_inb = torch.all(inb, dim=-1) & geo.valid
    oob = pair_ok & ~all_inb
    act = (pair_ok & all_inb)[..., None].expand(inb.shape)
    zero = torch.zeros_like(r)
    energy = torch.sum(torch.where(act, wt * r * r * (2.0 - hw), zero),
                       dim=-1)
    ucn, vcn, _, _, _, dcn, _ = _project(calib, R_th, t_th, points.u[None],
                                         points.v[None],
                                         points.idepth[None])
    return BAResiduals(
        r=r, wt=torch.where(act, wt, zero), J_pose_t=Jr_xi_t,
        J_pose_h=Jr_xi_h, J_aff_t=J_aff_t, J_aff_h=J_aff_h, J_calib=Jr_cal,
        J_dd=Jr_dd, active=act, energy=energy, oob=oob,
        u_new=ucn, v_new=vcn, idepth_new=dcn)
