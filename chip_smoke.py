"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # needs one CUDA device

Phases (any failure raises and exits non-zero; there is no CPU fallback):
 1. print the card (`nvidia-smi` name and power limit) and versions;
 2. build every kernel of the main path from csrc/ (one nvcc per source,
    all started together) into build/kernels/;
 3. hold each kernel against its plain PyTorch version on the card, at the
    shapes the main path gives it and on edge cases, and time the kernel,
    the plain version and a PyTorch library yardstick;
 4. drive the port's main path through its user entry point
    (FullSystem.add_frame): serial visual odometry at 512x512 with the
    reference operating point's window (F=8, P=2048), launch counters set
    to 0 just before and read just after; check the trajectory against
    ground truth (sim3 ATE gate) and the system's health;
 5. print the `kernels` JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmvio_tpu_torch  # noqa: E402  (fails outside a checkout)
from dmvio_tpu_torch import kernels  # noqa: E402
from dmvio_tpu_torch.models import full_system, window  # noqa: E402
from dmvio_tpu_torch.ops import patch_sample, pyramid, select  # noqa: E402
from dmvio_tpu_torch.utils import lie, synthetic, timing  # noqa: E402
from dmvio_tpu_torch.utils import trajectory  # noqa: E402
from dmvio_tpu_torch.utils.camera import (PATTERN, Calib,  # noqa: E402
                                          PATTERN_CENTER)

H = W = 512
# 40 frames: the window fills (13 keyframes for max_frames=7) and every
# stage runs, marginalization included. Past frame ~45 the path's growing
# rotation makes the outcome chaotic in float32 for the JAX reference and
# the port alike (see PERF.md), so a longer smoke would pass by chance.
N_FRAMES = 40
CFG = dict(f_max=8, p_max=2048, i_max=2048, max_frames=7, levels=6,
           ba_iters=6, realtime=False)
# sim3 ATE of the JAX reference (dmvio_tpu, XLA on the CPU) on this exact
# sequence, printed by `tools/reference_smoke_ate.py 40` (see PERF.md). The
# gate is the larger of 3% of the path and 1.5x this value.
REF_ATE_SIM3 = 0.02174404397808623
ATOL = 1e-4            # on 0-255 intensities: a few f32 ulps at 255
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


def log(*a):
    print(*a, flush=True)


def pose(i):
    """bench.py's warm-up path (world-to-cam pose of frame i)."""
    center = np.array([0.035 * i, 0.015 * np.sin(i * 0.4), 0.004 * i])
    w_vec = np.array([0.002 * i, -0.004 * i, 0.001 * i])
    R_wc = lie.so3_exp(torch.tensor(w_vec, dtype=torch.float32)).numpy()
    R_cw = R_wc.T
    return (torch.tensor(R_cw, dtype=torch.float32),
            torch.tensor(-R_cw @ center, dtype=torch.float32))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 25, per_graph: int = 20) -> float:
    """Median device time of one call of `fn`, from CUDA-graph replays of
    `per_graph` back-to-back calls (no host launch overhead in the number),
    timed with CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    del g
    return statistics.median(times)


def call_ms(fn, reps: int = 25) -> float:
    """Median time of one eager call (host dispatch included)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# K1: patch sampling
# ---------------------------------------------------------------------------


def k1_operating_inputs(dev):
    """T=8 window frames of the smoke sequence as the [F, 3, H, W] stack,
    N=2048 points selected in frame 0 with ground-truth inverse depth, and
    their pattern pixels warped into every frame (u, v [8, 2048, 8])."""
    calib = Calib.create(380.0, 380.0, W / 2 - 0.5, H / 2 - 0.5, dev)
    scene = synthetic.default_scene(2.0, device=dev)
    T, N = 8, 2048
    poses = [tuple(x.to(dev) for x in pose(2 * i)) for i in range(T)]
    stack = torch.stack([pyramid.build_pyramid(
        synthetic.render(scene, R, t, calib, H, W), levels=1)[0]
        for R, t in poses])                                  # [T, 3, H, W]
    sel = select.select_points(stack[0], N, pot=4)
    idepth = synthetic.gt_idepth(scene, *poses[0], calib, sel.u, sel.v)
    pat = torch.as_tensor(PATTERN, device=dev)
    up = sel.u[:, None] + pat[:, 0]
    vp = sel.v[:, None] + pat[:, 1]
    ray = torch.stack([(up - calib.cx) / calib.fx, (vp - calib.cy) / calib.fy,
                       torch.ones_like(up)], -1)             # [N, K, 3]
    us, vs = [], []
    R0, t0 = poses[0]
    for R, t in poses:
        R_th = R @ R0.T
        t_th = t - R_th @ t0
        p = ray @ R_th.T + t_th * idepth[:, None, None]
        us.append(p[..., 0] / p[..., 2] * calib.fx + calib.cx)
        vs.append(p[..., 1] / p[..., 2] * calib.fy + calib.cy)
    return stack, torch.stack(us), torch.stack(vs)


def k1_edge_inputs(dev):
    """Edge cases: image-edge anchors, out-of-patch stretch, and centres at
    +-1e10, +-inf and NaN (whole pattern rows follow their centre)."""
    rng = np.random.default_rng(7)
    h, w, N, K = 64, 96, 64, 8
    img = rng.uniform(0, 255, (2, h, w)).astype(np.float32)
    uc = rng.uniform(-6, w + 6, (2, N)).astype(np.float32)
    vc = rng.uniform(-6, h + 6, (2, N)).astype(np.float32)
    special = np.array([1e10, -1e10, np.inf, -np.inf, np.nan, 0.0, w - 1.0,
                        -0.5], np.float32)
    uc[0, :8] = special
    vc[1, :8] = special[::-1]
    off = rng.uniform(-3, 3, (2, N, K)).astype(np.float32)
    off[:, 40:48] *= 6.0                                     # stretch
    u = uc[..., None] + off
    v = vc[..., None] + off[..., ::-1]
    u[..., PATTERN_CENTER] = uc
    v[..., PATTERN_CENTER] = vc
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t(img), t(u), t(v)


def compare_k1(img, u, v, label: str) -> float:
    """Kernel vs plain on the same inputs; returns the max abs error."""
    got = patch_sample.sample_patch3(img, u, v)
    ref = patch_sample.sample_patch3_plain(img, u, v)
    torch.cuda.synchronize()
    if not torch.equal(got[3], ref[3]):
        raise AssertionError(f"K1 {label}: ok differs in "
                             f"{int((got[3] != ref[3]).sum())} samples")
    err = 0.0
    for name, a, b in zip(("i", "gx", "gy"), got[:3], ref[:3]):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"K1 {label}: NaN pattern of {name} differs")
        fin = ~torch.isnan(a)
        if fin.any():
            e = float((a[fin] - b[fin]).abs().max())
            err = max(err, e)
    if not err <= ATOL:
        raise AssertionError(f"K1 {label}: max abs error {err} > {ATOL}")
    log(f"K1 {label}: ok equal, max abs err {err:.3g} (atol {ATOL})")
    return err


def k1_bound(img, u, v):
    """Least time for K1 on these inputs: the level-0 texels its stencils
    touch (each read once) + coordinates read + outputs written, over the
    memory rate, against its float operations over the f32 rate."""
    T, N, K = u.shape
    _, h, w = img.shape
    x0, y0 = patch_sample.anchors(u[..., PATTERN_CENTER],
                                  v[..., PATTERN_CENTER], h, w)
    pu = torch.nan_to_num(torch.clamp(u - x0[..., None], 1.0, 13.999), 1.0)
    pv = torch.nan_to_num(torch.clamp(v - y0[..., None], 1.0, 13.999), 1.0)
    c = torch.floor(pu).long()
    r = torch.floor(pv).long()
    taps = [(0, -1), (0, 0), (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (1, 2),
            (2, 0), (2, 1), (-1, 0), (-1, 1)]
    touched = torch.zeros(T * h * w, dtype=torch.bool, device=img.device)
    tt = torch.arange(T, device=img.device)[:, None, None]
    for dr, dc in taps:
        flat = (tt * h + y0[..., None] + r + dr) * w + x0[..., None] + c + dc
        touched[flat.reshape(-1)] = True
    n_samples = T * N * K
    nbytes = 4 * int(touched.sum()) + 2 * 4 * n_samples + 13 * n_samples
    flops = 60 * n_samples          # 13 lerps (3 flops) + index/clip math
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def k1_library_fn(img, u, v):
    """Yardstick: one grid_sample over the 5 shifted coordinate sets (the
    samples K1 combines into I, gx, gy). Timed only; the port never calls
    it."""
    T, N, K = u.shape
    _, h, w = img.shape
    src = img[:, None]
    uu = torch.stack([u, u + 1, u - 1, u, u], 1).reshape(T, 5 * N * K, 1)
    vv = torch.stack([v, v, v, v + 1, v - 1], 1).reshape(T, 5 * N * K, 1)
    grid = torch.stack([2.0 * uu / (w - 1) - 1.0, 2.0 * vv / (h - 1) - 1.0],
                       -1)

    def fn():
        return torch.nn.functional.grid_sample(
            src, grid, mode="bilinear", padding_mode="border",
            align_corners=True)
    return fn


def phase_kernels(dev):
    stack, u, v = k1_operating_inputs(dev)
    img = stack[:, 0]                     # strided view, as on the main path
    err = compare_k1(img, u, v, "operating point T=8 N=2048 K=8")
    e_img, e_u, e_v = k1_edge_inputs(dev)
    err = max(err, compare_k1(e_img, e_u, e_v, "edge cases"))
    ms = device_ms(lambda: patch_sample.sample_patch3(img, u, v))
    plain_ms = device_ms(lambda: patch_sample.sample_patch3_plain(img, u, v))
    lib_ms = device_ms(k1_library_fn(img.contiguous(), u, v))
    kernel_call_ms = call_ms(lambda: patch_sample.sample_patch3(img, u, v))
    bound_ms, bound_by, nbytes = k1_bound(img, u, v)
    log(f"K1 times (ms): kernel {ms:.5f} (eager call {kernel_call_ms:.5f}), "
        f"plain {plain_ms:.5f}, grid_sample x5 {lib_ms:.5f}, bound "
        f"{bound_ms:.6f} ({bound_by}, {nbytes} bytes)")
    return {
        "name": "K1_patch_sample3", "route": "cuda",
        "source": "dmvio_tpu_torch/csrc/patch_sample.cu",
        "replaces": "dmvio_tpu/ops/patch_sample.py:98",
        "max_abs_err": err, "max_err": err, "ok_equal": True,
        "ms": ms, "kernel_ms": ms, "call_ms": kernel_call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,
    }


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def main_path_inputs(dev):
    """Calibration, the rendered frames on `dev` and the ground-truth
    cam-to-world poses of the main path's sequence."""
    calib = Calib.create(380.0, 380.0, W / 2 - 0.5, H / 2 - 0.5, dev)
    scene = synthetic.default_scene(2.0, device=dev)
    frames = []
    gt = []
    for i in range(N_FRAMES):
        R, t = pose(i)
        frames.append(synthetic.render(scene, R.to(dev), t.to(dev), calib,
                                       H, W))
        R_wc, t_wc = lie.se3_inv(R, t)
        gt.append((i * 0.05, R_wc.numpy(), t_wc.numpy()))
    return calib, frames, gt


def phase_main_path(dev):
    calib, frames, gt = main_path_inputs(dev)
    cfg = window.Config(**CFG)
    fs = full_system.FullSystem(calib, H, W, cfg)           # device: cuda
    torch.cuda.synchronize()
    timing.reset()
    patch_sample.sample_patch3.launches = 0
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        fs.add_frame(img, timestamp=i * 0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = patch_sample.sample_patch3.launches

    est = fs.trajectory()
    if len(est) != N_FRAMES:
        raise AssertionError(f"{len(est)} poses for {N_FRAMES} frames")
    if not all(np.all(np.isfinite(p[1])) and np.all(np.isfinite(p[2]))
               for p in est):
        raise AssertionError("non-finite pose in the trajectory")
    ate = trajectory.ate_rmse(est, gt, with_scale=True)
    path = trajectory.path_length(np.stack([g[2] for g in gt]))
    gate = max(0.03 * path, 1.5 * REF_ATE_SIM3)
    stages = {k: v["median"] * 1e3 for k, v in timing.get_stats().items()}
    summary = {
        "frames": N_FRAMES, "keyframes": fs.stats_kf,
        "resets": fs.stats_resets, "lost_frames": fs.stats_lost_frames,
        "wall_s": wall, "fps": N_FRAMES / wall, "ate_sim3": ate,
        "path_length": path, "ate_gate": gate,
        "k1_launches": launches, "stage_median_ms": stages,
    }
    log("main path: " + json.dumps(summary))
    checks = [
        (fs.initialized, "not initialized"),
        (not fs.is_lost, "lost at the end"),
        (fs.stats_resets == 0, f"{fs.stats_resets} resets"),
        (fs.stats_kf >= cfg.max_frames + 2,
         f"only {fs.stats_kf} keyframes: the window never filled"),
        (launches > 0, "K1 was never launched on the main path"),
        (math.isfinite(ate) and ate < gate, f"ATE {ate} >= gate {gate}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError("main path: " + msg)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = dmvio_tpu_torch.device()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = kernels.build(["patch_sample"])
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log("patch_sample").splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    k1 = phase_kernels(dev)
    k1["launches"] = k1["launches_main_path"] = phase_main_path(dev)
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
