"""Joint pose + per-point inverse-depth GN for monocular initialization.

Counterpart of dmvio_tpu/ops/init_gn.py (CoarseInitializer::trackFrame /
calcResAndGS as one LM per pyramid level over [xi(6), rho, b] jointly with
every point's inverse depth, Schur complement on the idepth block,
grid-splat depth smoothing and the "alpha" prior until snapped).

The reference vmaps the whole coarse-to-fine program over C hypotheses;
here every tensor carries the hypothesis axis C explicitly, and the
per-level `while_loop` is a Python loop whose per-hypothesis updates are
gated by `active = (it < iters) & ~done`, exactly the semantics of a
vmapped while_loop. The loop ends when no hypothesis is active (one host
read per iteration).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmvio_tpu_torch.ops import interp
from dmvio_tpu_torch.ops._cast import to_int32
from dmvio_tpu_torch.utils import lie
from dmvio_tpu_torch.utils.camera import Calib, pattern

HUBER_TH = 9.0
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
GRID = 8
ITERS = (50, 50, 30, 10, 5, 5)     # per level, fine -> coarse


class InitLevelState(NamedTuple):
    R: torch.Tensor        # [C, 3, 3]
    t: torch.Tensor        # [C, 3]
    rho: torch.Tensor      # [C]
    b_aff: torch.Tensor    # [C]
    idepth: torch.Tensor   # [C, N]
    lam: torch.Tensor      # [C]
    energy: torch.Tensor   # [C]
    snapped: torch.Tensor  # [C] bool
    it: torch.Tensor       # [C] int32
    done: torch.Tensor     # [C] bool


def _smooth_target(u, v, idepth, mask, h, w):
    """Regularization target iR [C, N]: grid-splat + 3x3 box blur + gather.

    The splat is a scatter-add; `index_put_(accumulate=True)` sums the
    duplicates of each cell in index order on the CPU and through a sorted,
    deterministic segment pass on CUDA (no float atomics)."""
    C, N = idepth.shape
    dev = idepth.device
    gh, gw = h // GRID + 1, w // GRID + 1
    gx = torch.clamp(to_int32(u / GRID), 0, gw - 1).long()
    gy = torch.clamp(to_int32(v / GRID), 0, gh - 1).long()
    cell = gy * gw + gx                                       # [N]
    flat = (torch.arange(C, device=dev)[:, None] * (gh * gw)
            + cell[None, :]).reshape(-1)
    mf = mask.to(torch.float32)
    wsum = torch.zeros(C * gh * gw, device=dev).index_put_(
        (flat,), mf.expand(C, N).reshape(-1), accumulate=True)
    dsum = torch.zeros(C * gh * gw, device=dev).index_put_(
        (flat,), torch.where(mask, idepth, torch.zeros_like(idepth))
        .reshape(-1), accumulate=True)

    def box3(a):
        ap = torch.nn.functional.pad(a.reshape(C, 1, gh, gw), (1, 1, 1, 1),
                                     mode="replicate")[:, 0]
        return (ap[:, :-2, :-2] + ap[:, :-2, 1:-1] + ap[:, :-2, 2:]
                + ap[:, 1:-1, :-2] + ap[:, 1:-1, 1:-1] + ap[:, 1:-1, 2:]
                + ap[:, 2:, :-2] + ap[:, 2:, 1:-1] + ap[:, 2:, 2:]
                ).reshape(C, gh * gw)

    wsum_b = box3(wsum)
    dsum_b = box3(dsum)
    iR_grid = dsum_b / torch.clamp(wsum_b, min=1e-6)
    iR = iR_grid[:, cell]
    have = wsum_b[:, cell] > 1e-6
    return torch.where(have, iR, idepth)


def _level_system(tgt_level, calib_l: Calib, u, v, color, pmask,
                  R, t, rho, b_aff, idepth):
    """Residuals + Jacobians of all points and pattern pixels, per
    hypothesis. Shapes: u, v [N]; color [N, K]; R [C,3,3]; idepth [C, N]."""
    h, w = tgt_level.shape[-2:]
    pat = pattern(u.device)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    xr = (up - calib_l.cx) / calib_l.fx
    yr = (vp - calib_l.cy) / calib_l.fy
    ray = torch.stack([xr, yr, torch.ones_like(xr)], dim=-1)   # [N, K, 3]
    pt = torch.einsum("cij,nkj->cnki", R, ray) + \
        t[:, None, None, :] * idepth[:, :, None, None]         # [C, N, K, 3]
    pz = pt[..., 2]
    vz = pz > 1e-6
    pzs = torch.where(vz, pz, torch.ones_like(pz))
    x = pt[..., 0] / pzs
    y = pt[..., 1] / pzs
    un = x * calib_l.fx + calib_l.cx
    vn = y * calib_l.fy + calib_l.cy
    inb = interp.in_bounds(un, vn, h, w, pad=2.0) & vz

    samp = interp.bilinear_stack(tgt_level, un, vn)            # [C,N,K,3]
    i_t, gx, gy = samp[..., 0], samp[..., 1], samp[..., 2]
    a = torch.exp(rho)[:, None, None]
    r = i_t - (a * color + b_aff[:, None, None])
    abs_r = torch.abs(r)
    hw = torch.where(abs_r < HUBER_TH, torch.ones_like(r),
                     HUBER_TH / torch.clamp(abs_r, min=1e-12))
    ok = inb & pmask[None, :, None]
    wt = torch.where(ok, hw, torch.zeros_like(hw))

    dn = idepth[:, :, None] / pzs
    gxf = gx * calib_l.fx
    gyf = gy * calib_l.fy
    J = torch.stack([
        dn * gxf, dn * gyf, -dn * (x * gxf + y * gyf),
        -(x * y * gxf + (1.0 + y * y) * gyf),
        (1.0 + x * x) * gxf + x * y * gyf,
        -y * gxf + x * gyf,
        -a * color * torch.ones_like(r),
        -torch.ones_like(r),
    ], dim=-1)                                                 # [C,N,K,8]
    tt = t[:, None, None, :]
    Jd = (gxf * (tt[..., 0] - tt[..., 2] * x)
          + gyf * (tt[..., 1] - tt[..., 2] * y)) / pzs

    energy = torch.sum(wt * r * r * (2.0 - hw), dim=(1, 2))
    nterm = torch.sum(ok.to(torch.float32), dim=(1, 2))
    Jw = J * wt[..., None]
    H_pp = torch.einsum("cnka,cnkb->cab", Jw, J)
    b_p = torch.einsum("cnka,cnk->ca", Jw, r)
    H_pd = torch.einsum("cnka,cnk->cna", Jw, Jd)
    H_dd = torch.einsum("cnk,cnk->cn", wt * Jd, Jd)
    b_d = torch.einsum("cnk,cnk->cn", wt * Jd, r)
    return H_pp, b_p, H_pd, H_dd, b_d, energy, nterm


def _total_energy(tgt_level, calib_l, u, v, color, pmask, R, t, rho, b_aff,
                  idepth, snapped):
    h, w = tgt_level.shape[-2:]
    *_, e, n = _level_system(tgt_level, calib_l, u, v, color, pmask,
                             R, t, rho, b_aff, idepth)
    iR = _smooth_target(u, v, idepth, pmask, h, w)
    zero = torch.zeros_like(idepth)
    e_reg = REG_WEIGHT * torch.sum(
        torch.where(pmask, (idepth - iR) ** 2, zero), dim=1)
    npts = torch.sum(pmask.to(torch.float32))
    e_alpha = torch.where(
        snapped, torch.zeros_like(e),
        ALPHA_W * (torch.sum(torch.where(pmask, (idepth - 1.0) ** 2, zero),
                             dim=1) + npts * torch.sum(t * t, dim=1)))
    return e / torch.clamp(n, min=1.0) * npts + e_reg + e_alpha


def _sel(accept, a, b):
    return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - 1)),
                       a, b)


def run_level(tgt_level, calib_l: Calib, u, v, color, pmask,
              R0, t0, rho0, b0, idepth0, iters: int,
              fix_aff: bool = False) -> InitLevelState:
    """Joint LM on one pyramid level for all hypotheses."""
    h, w = tgt_level.shape[-2:]
    dev = R0.device
    C = R0.shape[0]
    args = (tgt_level, calib_l, u, v, color, pmask)
    snapped0 = torch.sum(t0 * t0, dim=1) > (ALPHA_K / ALPHA_W)
    e0 = _total_energy(*args, R0, t0, rho0, b0, idepth0, snapped0)
    st = InitLevelState(
        R=R0, t=t0, rho=rho0, b_aff=b0, idepth=idepth0,
        lam=torch.full((C,), 0.1, device=dev), energy=e0, snapped=snapped0,
        it=torch.zeros(C, dtype=torch.int32, device=dev),
        done=torch.zeros(C, dtype=torch.bool, device=dev))
    npts = torch.sum(pmask.to(torch.float32))
    sel_t = torch.tensor([1., 1., 1., 0., 0., 0., 0., 0.], device=dev)
    eye8 = torch.eye(8, device=dev)
    while True:
        active = (st.it < iters) & ~st.done
        if not bool(active.any()):
            return st
        H_pp, b_p, H_pd, H_dd, b_d, e_ph, n_ph = _level_system(
            *args, st.R, st.t, st.rho, st.b_aff, st.idepth)
        scale_ph = (npts / torch.clamp(n_ph, min=1.0))
        H_pp = H_pp * scale_ph[:, None, None]
        b_p = b_p * scale_ph[:, None]
        H_pd = H_pd * scale_ph[:, None, None]
        H_dd = H_dd * scale_ph[:, None]
        b_d = b_d * scale_ph[:, None]

        iR = _smooth_target(u, v, st.idepth, pmask, h, w)
        H_dd = H_dd + REG_WEIGHT
        b_d = b_d + REG_WEIGHT * (st.idepth - iR)
        ns = (~st.snapped)[:, None]
        H_dd = H_dd + torch.where(ns, ALPHA_W, 0.0)
        b_d = b_d + torch.where(ns, ALPHA_W * (st.idepth - 1.0),
                                torch.zeros_like(b_d))
        alpha = torch.where(~st.snapped, ALPHA_W * npts,
                            torch.zeros_like(npts))
        H_pp = H_pp + alpha[:, None, None] * torch.diag(sel_t)
        b_p = b_p + alpha[:, None] * torch.cat(
            [st.t, torch.zeros(C, 5, device=dev)], dim=1)
        if fix_aff:
            H_pp = H_pp + torch.diag(torch.tensor(
                [0, 0, 0, 0, 0, 0, 1e8, 1e8], device=dev))

        lam = st.lam[:, None]
        Hdd_l = H_dd * (1.0 + lam) + 1e-10
        Hdd_inv = torch.where(pmask[None] & (H_dd > 0), 1.0 / Hdd_l,
                              torch.zeros_like(Hdd_l))
        H_sc = H_pp - torch.einsum("cna,cn,cnb->cab", H_pd, Hdd_inv, H_pd)
        b_sc = b_p - torch.einsum("cna,cn->ca", H_pd, b_d * Hdd_inv)
        dg = torch.diagonal(H_sc, dim1=-2, dim2=-1)
        Hl = H_sc + st.lam[:, None, None] * torch.diag_embed(dg) + 1e-6 * eye8
        d = torch.sqrt(torch.clamp(torch.diagonal(Hl, dim1=-2, dim2=-1),
                                   min=1e-10))
        step_p = torch.linalg.solve_ex(
            Hl / (d[:, :, None] * d[:, None, :]), -(b_sc / d))[0] / d
        step_p = torch.where(torch.isfinite(step_p), step_p,
                             torch.zeros_like(step_p))
        step_d = -(b_d + torch.einsum("cna,ca->cn", H_pd, step_p)) * Hdd_inv
        step_d = torch.clamp(step_d, -2.0, 2.0)

        Rn, tn = lie.se3_retract(st.R, st.t, step_p[:, :6])
        rhon = torch.clamp(st.rho + step_p[:, 6], -2.0, 2.0)
        bn = torch.clamp(st.b_aff + step_p[:, 7], -80.0, 80.0)
        dn_ = torch.where(pmask[None], torch.clamp(st.idepth + step_d,
                                                   1e-3, 50.0), st.idepth)
        snapped_n = st.snapped | (torch.sum(tn * tn, dim=1)
                                  > (ALPHA_K / ALPHA_W))
        en = _total_energy(*args, Rn, tn, rhon, bn, dn_, st.snapped)
        accept = (en < st.energy) & torch.isfinite(en)
        new = InitLevelState(
            R=_sel(accept, Rn, st.R), t=_sel(accept, tn, st.t),
            rho=_sel(accept, rhon, st.rho), b_aff=_sel(accept, bn, st.b_aff),
            idepth=_sel(accept, dn_, st.idepth),
            lam=torch.where(accept, torch.clamp(st.lam * 0.5, min=1e-5),
                            st.lam * 4.0),
            energy=_sel(accept, en, st.energy),
            snapped=torch.where(accept, snapped_n, st.snapped),
            it=st.it + 1,
            done=(torch.sum(step_p * step_p, dim=1) < 1e-12)
            | (st.lam > 1e5),
        )
        st = InitLevelState(*(_sel(active, a, b) for a, b in zip(new, st)))


def init_track_multi(first_pyr, new_pyr, calib0: Calib, u0, v0, pmask,
                     R_c, t_c, rho_c, b_c, idepth_c, levels: int = 5):
    """Coarse-to-fine joint init tracking of C hypotheses at once.

    u0/v0 [N] are level-0 point coordinates in the FIRST frame; colors are
    re-sampled per level from the first frame's pyramid. Returns
    (R [C,3,3], t [C,3], rho [C], b [C], idepth [C,N], packed [C,17])."""
    R, t, rho, b_aff, idepth = R_c, t_c, rho_c, b_c, idepth_c
    pat = pattern(u0.device)
    st = None
    for lvl in range(levels - 1, -1, -1):
        calib_l = calib0.at_level(lvl)
        s = 0.5 ** lvl
        ul = (u0 + 0.5) * s - 0.5
        vl = (v0 + 0.5) * s - 0.5
        ref_lvl = first_pyr[lvl]
        h_l, w_l = ref_lvl.shape[-2:]
        m = pmask & interp.in_bounds(ul, vl, h_l, w_l, pad=2.0)
        color = interp.bilinear(ref_lvl[0], ul[:, None] + pat[:, 0],
                                vl[:, None] + pat[:, 1])       # [N, K]
        st = run_level(new_pyr[lvl], calib_l, ul, vl, color, m,
                       R, t, rho, b_aff, idepth,
                       ITERS[min(lvl, len(ITERS) - 1)])
        R, t, rho, b_aff, idepth = st.R, st.t, st.rho, st.b_aff, st.idepth
    finite = torch.all(torch.isfinite(t), dim=1) & \
        torch.all(torch.isfinite(idepth), dim=1)
    C = R.shape[0]
    packed = torch.cat([
        R.reshape(C, 9), t, rho[:, None], b_aff[:, None],
        st.snapped.to(torch.float32)[:, None],
        finite.to(torch.float32)[:, None], st.energy[:, None]], dim=1)
    return R, t, rho, b_aff, idepth, packed
