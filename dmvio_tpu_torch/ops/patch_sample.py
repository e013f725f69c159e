"""Pattern sampling of (I, gx, gy) for BA linearization and activation.

Counterpart of dmvio_tpu/ops/patch_sample.py. The reference gathers one
16x16 level-0 patch per (target, point) pair with a Pallas kernel
(`_kernel`/`_gather_tpu`) and samples it with one-hot contractions
(`sample3`). Here one call does both for a whole batch of targets:

  sample_patch3(img [T, H, W], u [T, N, K], v [T, N, K])
      -> (i, gx, gy) [T, N, K] float32, ok [T, N, K] bool

On a CUDA tensor it launches the hand-written kernel K1
(csrc/patch_sample.cu); on a CPU tensor it runs `sample_patch3_plain`,
which follows the reference's gather + separable one-hot contraction step
by step. There is no fallback from one to the other.

Pattern index 4 of (u, v) is the warped centre that anchors the patch
(PATTERN[4] == (0, 0)). gx/gy are central differences of bilinear samples,
which equal bilinear samples of the central-difference gradient images.
"""

from __future__ import annotations

import ctypes

import torch

from dmvio_tpu_torch.ops._cast import to_int32, wrap_int32
from dmvio_tpu_torch.utils.camera import PATTERN_CENTER

PATCH = 16      # patch side
MARGIN = 7      # patch anchor = floor(center) - MARGIN


def anchors(uc: torch.Tensor, vc: torch.Tensor, h: int, w: int):
    """Top-left patch corners (int64) for central warp coords, clipped to
    the image, with the reference's int32 cast-and-wrap semantics."""
    def one(c, lim):
        a = wrap_int32(to_int32(torch.floor(c)).long() - MARGIN)
        return torch.clamp(a, 0, lim)
    return one(uc, w - PATCH), one(vc, h - PATCH)


def gather_patches(img: torch.Tensor, uc: torch.Tensor, vc: torch.Tensor):
    """[T, H, W] image stack + central coords [T, N] -> (patches
    [T, N, 16, 16], x0 [T, N], y0 [T, N]); patch rows y0..y0+15."""
    T, h, w = img.shape
    x0, y0 = anchors(uc, vc, h, w)
    r = torch.arange(PATCH, device=img.device)
    rows = (y0[..., None] + r)[..., :, None]                # [T, N, 16, 1]
    cols = (x0[..., None] + r)[..., None, :]                # [T, N, 1, 16]
    t = torch.arange(T, device=img.device)[:, None, None, None]
    return img[t, rows, cols], x0, y0


def _axis_weights(frac_idx: torch.Tensor, off: int) -> torch.Tensor:
    """One-hot bilinear weights [..., 16] along one patch axis."""
    f = torch.floor(frac_idx)
    i0 = to_int32(f).long() + off
    d = frac_idx - f
    rr = torch.arange(PATCH, device=frac_idx.device)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return (torch.where(rr == i0[..., None], (1.0 - d)[..., None], zero)
            + torch.where(rr == i0[..., None] + 1, d[..., None], zero))


def sample3(patches, x0, y0, u, v):
    """Bilinear (I, gx, gy) at absolute coords (u, v) [..., N, K] from
    patches [..., N, 16, 16]; ok marks samples whose full stencil lies in
    the patch. Same separable contraction as the reference's sample3."""
    pu = u - x0[..., None].to(u.dtype)
    pv = v - y0[..., None].to(v.dtype)
    ok = (pu >= 1.0) & (pu <= PATCH - 2.001) & \
        (pv >= 1.0) & (pv <= PATCH - 2.001)
    pu = torch.clamp(pu, 1.0, PATCH - 2.001)
    pv = torch.clamp(pv, 1.0, PATCH - 2.001)
    K = pu.shape[-1]
    wy_all = torch.cat([_axis_weights(pv, 0), _axis_weights(pv, +1),
                        _axis_weights(pv, -1)], dim=-2)        # [.., 3K, 16]
    rows = torch.einsum("...yx,...ky->...kx", patches, wy_all)
    s0, sp, sm = rows[..., :K, :], rows[..., K:2 * K, :], rows[..., 2 * K:, :]
    wx0 = _axis_weights(pu, 0)
    cols_s = torch.cat([s0, s0, s0, sp, sm], dim=-2)          # [.., 5K, 16]
    cols_w = torch.cat([wx0, _axis_weights(pu, +1), _axis_weights(pu, -1),
                        wx0, wx0], dim=-2)
    val = (cols_s * cols_w).sum(-1)                           # [.., 5K]
    i_t = val[..., :K]
    gx = 0.5 * (val[..., K:2 * K] - val[..., 2 * K:3 * K])
    gy = 0.5 * (val[..., 3 * K:4 * K] - val[..., 4 * K:])
    return i_t, gx, gy, ok


def sample_patch3_plain(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of K1: gather_patches + sample3."""
    patches, x0, y0 = gather_patches(img, u[..., PATTERN_CENTER],
                                     v[..., PATTERN_CENTER])
    return sample3(patches, x0, y0, u, v)


def _check(img, u, v):
    if img.dim() != 3 or u.dim() != 3 or u.shape != v.shape \
            or u.shape[0] != img.shape[0]:
        raise ValueError(f"sample_patch3: shapes img {tuple(img.shape)}, "
                         f"u {tuple(u.shape)}, v {tuple(v.shape)}")
    if img.dtype != torch.float32 or u.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise TypeError("sample_patch3: float32 tensors expected")
    if img.shape[1] < PATCH or img.shape[2] < PATCH:
        raise ValueError("sample_patch3: image smaller than the patch")
    if u.shape[-1] <= PATTERN_CENTER:
        raise ValueError("sample_patch3: pattern axis too short")


def sample_patch3(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(i, gx, gy, ok) of the pattern samples; see the module docstring.

    `img` may be a strided view (channel 0 of the window's [F, 3, H, W]
    stack): the kernel takes its frame and row strides, so no copy is made.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    _check(img, u, v)
    if img.device.type == "cpu":
        return sample_patch3_plain(img, u, v)
    if img.device.type != "cuda" or u.device != img.device \
            or v.device != img.device:
        raise ValueError("sample_patch3: tensors must share one CUDA device")
    if img.stride(2) != 1:
        raise ValueError("sample_patch3: image rows must be contiguous")
    u = u.contiguous()
    v = v.contiguous()
    T, N, K = u.shape
    _, H, W = img.shape
    lib = _library()
    out_i = torch.empty((T, N, K), dtype=torch.float32, device=img.device)
    out_gx = torch.empty_like(out_i)
    out_gy = torch.empty_like(out_i)
    out_ok = torch.empty((T, N, K), dtype=torch.bool, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = lib.dmvio_patch_sample3(
        img.data_ptr(), img.stride(0), img.stride(1), u.data_ptr(),
        v.data_ptr(), out_i.data_ptr(), out_gx.data_ptr(), out_gy.data_ptr(),
        out_ok.data_ptr(), T, N, K, H, W, PATTERN_CENTER, stream)
    if rc != 0:
        raise RuntimeError(f"patch_sample3 kernel launch failed: CUDA error "
                           f"{rc}")
    sample_patch3.launches += 1
    return out_i, out_gx, out_gy, out_ok


sample_patch3.launches = 0


def _library():
    from dmvio_tpu_torch import kernels

    lib = kernels.load("patch_sample")
    fn = lib.dmvio_patch_sample3
    if fn.argtypes is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        i = ctypes.c_int
        fn.argtypes = [p, ll, ll, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
