"""Direct photometric image alignment: residuals + Gauss-Newton system.

Counterpart of dmvio_tpu/ops/align.py (CoarseTracker::calcRes +
calcGSSSE). Every function takes a batch of B poses at once — the
tracker's candidate ladder, which the reference vmaps — against one shared
reference point cloud: R [B, 3, 3], t [B, 3], aff_a/aff_b/cutoff_mult [B].
The local 8-dof state is delta = [v(3), w(3), rho, b] with brightness model
r = I_new(u', v') - (a * c_ref + b), a = exp(rho_rel).

The reference samples small pyramid levels through one-hot matmuls
(`_MXU_SAMPLE_AREA`); both branches compute the same bilinear sample, so
the port always gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvio_tpu_torch.ops import interp
from dmvio_tpu_torch.utils.camera import Calib


class AlignStats(NamedTuple):
    energy: torch.Tensor      # [B] Huber energy over inlier terms
    num_terms: torch.Tensor   # [B] in-bounds, non-saturated terms
    num_saturated: torch.Tensor
    flow_t: torch.Tensor      # [B] RMS pixel motion, translation only
    flow_rt: torch.Tensor     # [B] RMS pixel motion, full warp


class PointCloud(NamedTuple):
    """Reference semi-dense point cloud at one pyramid level (masked)."""

    u: torch.Tensor       # [N] pixel x in ref frame at this level
    v: torch.Tensor       # [N] pixel y
    idepth: torch.Tensor  # [N] inverse depth in ref frame
    color: torch.Tensor   # [N] ref intensity
    mask: torch.Tensor    # [N] bool validity


def warp_points(pc: PointCloud, calib_l: Calib, R: torch.Tensor,
                t: torch.Tensor):
    """Warp reference points by B poses: (u', v', x', y', d', valid) [B, N]."""
    xr = (pc.u - calib_l.cx) / calib_l.fx
    yr = (pc.v - calib_l.cy) / calib_l.fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)  # [N, 3]
    p = torch.einsum("nj,bij->bni", ray, R) + \
        t[:, None, :] * pc.idepth[None, :, None]
    pz = p[..., 2]
    valid = pz > 1e-6
    pz_safe = torch.where(valid, pz, torch.ones_like(pz))
    xn = p[..., 0] / pz_safe
    yn = p[..., 1] / pz_safe
    dn = pc.idepth[None] / pz_safe
    un = xn * calib_l.fx + calib_l.cx
    vn = yn * calib_l.fy + calib_l.cy
    return un, vn, xn, yn, dn, valid


def _huber(abs_r, huber_th):
    return torch.where(abs_r < huber_th, torch.ones_like(abs_r),
                       huber_th / torch.clamp(abs_r, min=1e-12))


def _cutoff(cutoff_th, cutoff_mult, r):
    m = torch.as_tensor(cutoff_mult, dtype=r.dtype, device=r.device)
    return (cutoff_th * m).reshape(-1, 1)


def calc_sat_profile(tgt_level, calib_l: Calib, pc: PointCloud, R, t,
                     aff_a, aff_b, cutoff_th: float = 20.0,
                     mults=(1.0, 2.0, 4.0)):
    """Saturation ratios at several cutoff multipliers from one sampling
    pass: [B, len(mults)]."""
    h, w = tgt_level.shape[-2:]
    un, vn, _, _, _, valid_z = warp_points(pc, calib_l, R, t)
    inb = interp.in_bounds(un, vn, h, w, pad=2.0) & valid_z & pc.mask
    i_new = interp.bilinear(tgt_level[0], un, vn)
    abs_r = torch.abs(i_new - (aff_a[:, None] * pc.color + aff_b[:, None]))
    n_inb = torch.clamp(torch.sum(inb.to(torch.float32), dim=1), min=1.0)
    return torch.stack([
        torch.sum(((abs_r > cutoff_th * m) & inb).to(torch.float32), dim=1)
        / n_inb for m in mults], dim=1)


def calc_res_and_gs(tgt_level, calib_l: Calib, pc: PointCloud, R, t,
                    aff_a, aff_b, huber_th: float = 9.0,
                    cutoff_th: float = 20.0, cutoff_mult=1.0):
    """Residuals + 8x8 GN system for one pyramid level and B poses.

    Returns (H [B,8,8], b [B,8], AlignStats). Solve H d = -b for the step."""
    h, w = tgt_level.shape[-2:]
    un, vn, xn, yn, dn, valid_z = warp_points(pc, calib_l, R, t)
    inb = interp.in_bounds(un, vn, h, w, pad=2.0) & valid_z & pc.mask
    samp = interp.bilinear_stack(tgt_level, un, vn)           # [B, N, 3]
    i_new, gx, gy = samp[..., 0], samp[..., 1], samp[..., 2]

    a = aff_a[:, None]
    r = i_new - (a * pc.color + aff_b[:, None])
    abs_r = torch.abs(r)
    cutoff = _cutoff(cutoff_th, cutoff_mult, r)
    saturated = (abs_r > cutoff) & inb
    active = inb & ~saturated
    hw = _huber(abs_r, huber_th)
    zero = torch.zeros_like(r)
    energy = torch.sum(torch.where(active, hw * r * r * (2.0 - hw), zero)
                       + torch.where(saturated, cutoff * cutoff * 2.0, zero),
                       dim=1)

    gxf = gx * calib_l.fx
    gyf = gy * calib_l.fy
    J = torch.stack([
        dn * gxf,
        dn * gyf,
        -dn * (xn * gxf + yn * gyf),
        -(xn * yn * gxf + (1.0 + yn * yn) * gyf),
        (1.0 + xn * xn) * gxf + xn * yn * gyf,
        -yn * gxf + xn * gyf,
        (-a * pc.color).expand_as(r),
        -torch.ones_like(r),
    ], dim=-1)                                                # [B, N, 8]
    wgt = torch.where(active, hw, zero)
    Jw = J * wgt[..., None]
    H = Jw.transpose(1, 2) @ J
    b = (Jw * r[..., None]).sum(1)

    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    un_t, vn_t, *_, valid_t = warp_points(pc, calib_l, eye, t)
    n_act = torch.clamp(torch.sum(active.to(torch.float32), dim=1), min=1.0)
    flow_rt = torch.sum(torch.where(
        active, (un - pc.u) ** 2 + (vn - pc.v) ** 2, zero), dim=1) / n_act
    flow_t = torch.sum(torch.where(
        active & valid_t, (un_t - pc.u) ** 2 + (vn_t - pc.v) ** 2, zero),
        dim=1) / n_act
    stats = AlignStats(
        energy=energy,
        num_terms=torch.sum(active.to(torch.float32), dim=1),
        num_saturated=torch.sum(saturated.to(torch.float32), dim=1),
        flow_t=torch.sqrt(flow_t), flow_rt=torch.sqrt(flow_rt))
    return H, b, stats
