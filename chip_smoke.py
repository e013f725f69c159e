"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # needs one CUDA device

Phases (any failure raises and exits non-zero; there is no CPU fallback):
 1. print the card (`nvidia-smi` name and power limit) and versions;
 2. build every kernel of the main path from csrc/ (one nvcc per source,
    all started together) into build/kernels/, and the native dataset
    loader (native/dataloader.cpp, g++) into build/native/;
 3. hold each kernel against its plain PyTorch version on the card, at the
    shapes the main path gives it and on edge cases, and time the kernel,
    the plain version and a PyTorch library yardstick; time the launch
    floor (a one-block no-op kernel through the same route) and sweep K1
    over N = 512 .. 8192 points, printing kernel and bound times;
 4. drive the port's main path through its user entry point
    (FullSystem.add_frame): serial visual odometry at 512x512 with the
    reference operating point's window (F=8, P=2048), launch counters set
    to 0 just before and read just after; check the trajectory against
    ground truth (sim3 ATE gate) and the system's health;
 5. drive the serial visual-inertial path the same way
    (FullSystem(..., imu_calib=IMUCalib()).add_frame(img, ts, imu_data)):
    bench.py's VIO sequence at 512x512, through the visual init, the
    coarse IMU init, ACTIVE VIO (joint BA, IMU-aided tracking, extended
    marginalization, delayed log) and a PGBA cycle; check the metric
    trajectory (se3 and sim3 ATE gates) and the system's health, with K1's
    launches counted separately from the VO phase;
 6. drive the realtime pipeline (Config realtime=True, the rt_* knobs and
    async_fetch at their defaults) through add_frame and finish() on the
    VO phase's sequence (rt-vo-512: deferred visual keyframes) and on 120
    frames of the VIO phase's (rt-vio-512: deferred keyframes before and
    after the IMU turns ACTIVE, the IMU preview prior), each with the
    serial phase's health checks (at these knobs the reference itself
    makes few keyframes, so neither fills the window nor reaches PGBA;
    see RT_VO_MIN_KEYFRAMES, RT_VIO_FRAMES), an ATE gate from the JAX
    reference's realtime run, K1's launches counted on its own, and the
    pipeline's numbers: frames/s, stage medians, the fetch and decision
    waits, the largest in-flight queue, host syncs per frame (PyTorch's
    sync debug mode, over the last frames) and frame times while a PGBA
    thread ran;
 7. drive the port's dataset CLI (cli-vio-512): write a photometric
    synthetic VIO dataset with the port's make_synthetic on the card, run
    run_dataset.run in-process on it with the IMU, the native prefetch
    loader, the headless and HTTP viewers and the inertial streams
    attached; check every output file, the health counters and the ATE of
    result.txt (sim3) and resultScaled.txt (se3) against gt.csv, and print
    frames/s, the loader's time per frame and K1's launches on this path;
 8. print the `kernels` JSON line, the card line, and last the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmvio_tpu_torch  # noqa: E402  (fails outside a checkout)
from dmvio_tpu_torch import kernels, run_dataset  # noqa: E402
from dmvio_tpu_torch.io import native  # noqa: E402
from dmvio_tpu_torch.models import full_system, imu_system  # noqa: E402
from dmvio_tpu_torch.models import window  # noqa: E402
from dmvio_tpu_torch.ops import patch_sample, pyramid, select  # noqa: E402
from dmvio_tpu_torch.tools import make_synthetic  # noqa: E402
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
# VIO phase: bench.py's VIO sequence (bench_vio) for 60 frames: the IMU
# becomes ACTIVE near frame 32 and the first PGBA cycle completes near
# frame 46 in the JAX reference. Its worst se3 / sim3 ATE over three runs
# (clean, and 1e-2 intensity noise from numpy seeds 1 and 2) printed by
# `tools/reference_smoke_ate.py --vio 90 --from 50` at 60 frames (see
# PERF.md); each gate is the larger of the test suite's scale and 1.5x it.
VIO_FRAMES = 60
VIO_SEQ = dict(frame_dt=0.05, s_dso=1.3, g2=(0.05, -0.03), accel_scale=0.5,
               rot_scale=0.3, seed=2)
REF_VIO_SE3 = 0.11746030252230089
REF_VIO_SIM3 = 0.015815510671790052
# Realtime phases: the same sequences through the realtime pipeline. Gates
# from the JAX reference's realtime runs (async_fetch=False, flushed with
# finish()) printed by `tools/reference_smoke_ate.py --rt 40` and
# `--rt --vio 120` (worst of three runs for VIO), with the rules above.
RT_CFG = dict(CFG, realtime=True)
REF_RT_ATE_SIM3 = 0.06218563486963141
# The dispatch-time keyframe score grows with the square root of the
# baseline (ROADMAP.md queue 3), so on this sequence the reference's
# realtime run makes 5 keyframes in 40 frames and never fills the window;
# rt-vo-512 asks for two deferred keyframes besides the initializer's.
RT_VO_MIN_KEYFRAMES = 4
# The realtime VIO phase runs 120 frames of the same sequence: at the rt_*
# defaults the reference's realtime run turns ACTIVE only at frame 56 and
# makes 7 keyframes in 120 frames (`--rt --vio 120`); PGBA, which needs
# several marginalizations more, lies beyond a smoke's length (PERF.md).
RT_VIO_FRAMES = 120
SYNC_WINDOW = 10
REF_RT_VIO_SE3 = 0.0536047279579157
REF_RT_VIO_SIM3 = 0.046614582321374526
# CLI phase: the port's make_synthetic (seed 4, used by no other phase) at
# 512x512 with a baked response and vignette, run through run_dataset with
# the IMU. CLI_FRAMES is the smallest frame count at which the JAX CLI on
# the same arguments (on the CPU) is ACTIVE with a PGBA cycle done in all
# three runs of `tools/reference_smoke_ate.py --cli` (clean, 1e-2
# intensity noise from seeds 1 and 2); the gates are max(the CLI test
# suite's share of path: sim3 0.04 dist + 0.01, se3 0.10 dist + 0.01; 1.5x
# the worst of those runs at CLI_FRAMES), scored over every frame as
# tests/test_cli_e2e.py scores result.txt and resultScaled.txt.
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_DATA = os.path.join(ROOT, "build", "cli_data")
CLI_OUT = os.path.join(ROOT, "build", "cli_out") + os.sep
CLI_SYNTH = ["w=512", "h=512", "photometric=1", "seed=4"]
CLI_ARGS = ["useimu=1", "preset=0", "nativeLoader=1", "nogui=0",
            "viewerPort=0", "quiet=1"]
# `tools/reference_smoke_ate.py --cli 90 --from 30`: every run ACTIVE at
# frame 34 and through its first PGBA cycle at frame 47, so 48 frames.
CLI_FRAMES = 48
REF_CLI_SIM3 = 0.009287827306270802
REF_CLI_SE3 = 0.14254867849080516
CLI_FILES = ("result.txt", "resultKFs.txt", "resultScaled.txt",
             "timings.txt", "usedSettings.txt", "scalesdso.txt",
             "babiasdso.txt", "bavel.txt", "bagravdir.txt",
             os.path.join("viz", "index.html"))
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


def k1_window(dev):
    """T=8 window frames of the smoke sequence as the [F, 3, H, W] stack,
    with the scene, calibration and poses that made them."""
    calib = Calib.create(380.0, 380.0, W / 2 - 0.5, H / 2 - 0.5, dev)
    scene = synthetic.default_scene(2.0, device=dev)
    poses = [tuple(x.to(dev) for x in pose(2 * i)) for i in range(8)]
    stack = torch.stack([pyramid.build_pyramid(
        synthetic.render(scene, R, t, calib, H, W), levels=1)[0]
        for R, t in poses])                                  # [T, 3, H, W]
    return scene, calib, poses, stack


def k1_points(win, N: int):
    """N points selected in frame 0 of the window with ground-truth inverse
    depth, their pattern pixels warped into every frame: u, v [8, N, 8]."""
    scene, calib, poses, stack = win
    dev = stack.device
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
    return torch.stack(us), torch.stack(vs)


def k1_edge_inputs(dev):
    """Edge cases, each (label, img, u, v): image-edge anchors, out-of-patch
    stretch and centres at +-1e10, +-inf and NaN (whole pattern rows follow
    their centre); NaN in non-centre lanes of finite centres; every lane
    clipped to a corner of the patch (stencils across all of it); the
    pattern rotated by 45 degrees and scaled by 1.5."""
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
    inner_u = rng.uniform(10, w - 10, (2, N)).astype(np.float32)
    inner_v = rng.uniform(10, h - 10, (2, N)).astype(np.float32)
    lane_nan = np.where(rng.random((2, N, K)) < 0.2, np.nan, off)
    corner = rng.choice([-20.0, 20.0], (2, N, K)) \
        + rng.uniform(-1, 1, (2, N, K))
    a = math.pi / 4
    rot = 1.5 * np.array([[math.cos(a), -math.sin(a)],
                          [math.sin(a), math.cos(a)]])
    turned = PATTERN @ rot.T + rng.uniform(-0.3, 0.3, (2, N, K, 2))
    cases = [("edge cases", uc, vc, off, off[..., ::-1]),
             ("lane_nan", inner_u, inner_v, lane_nan, lane_nan[..., ::-1]),
             ("corner", inner_u, inner_v, corner, corner[..., ::-1]),
             ("rotated", inner_u, inner_v, turned[..., 0], turned[..., 1])]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    out = []
    for label, cu, cv, du, dv in cases:
        u = cu[..., None] + du
        v = cv[..., None] + dv
        u[..., PATTERN_CENTER] = cu
        v[..., PATTERN_CENTER] = cv
        out.append((label, t(img), t(u), t(v)))
    return out


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


def launch_floor_ms() -> float:
    """Device time of K1's library's one-block no-op kernel, launched
    through the same nvcc + ctypes route: the floor under every launch."""
    fn = kernels.load("patch_sample").dmvio_noop
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def noop():
        rc = fn(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"no-op kernel launch failed: CUDA error {rc}")
    return device_ms(noop)


def phase_kernels(dev):
    win = k1_window(dev)
    img = win[3][:, 0]                    # strided view, as on the main path
    u, v = k1_points(win, 2048)
    err = compare_k1(img, u, v, "operating point T=8 N=2048 K=8")
    for label, e_img, e_u, e_v in k1_edge_inputs(dev):
        err = max(err, compare_k1(e_img, e_u, e_v, label))
    ms = device_ms(lambda: patch_sample.sample_patch3(img, u, v))
    plain_ms = device_ms(lambda: patch_sample.sample_patch3_plain(img, u, v))
    lib_ms = device_ms(k1_library_fn(img.contiguous(), u, v))
    kernel_call_ms = call_ms(lambda: patch_sample.sample_patch3(img, u, v))
    bound_ms, bound_by, nbytes = k1_bound(img, u, v)
    floor_ms = launch_floor_ms()
    log(f"K1 times (ms): kernel {ms:.6f} (eager call {kernel_call_ms:.6f}), "
        f"plain {plain_ms:.6f}, grid_sample x5 {lib_ms:.6f}, bound "
        f"{bound_ms:.6f} ({bound_by}, {nbytes} bytes), share "
        f"{bound_ms / ms:.3f}; launch floor {floor_ms:.6f}")
    sweep = []
    for n in (512, 1024, 2048, 4096, 8192):
        su, sv = k1_points(win, n)
        compare_k1(img, su, sv, f"sweep T=8 N={n} K=8")
        k_ms = device_ms(lambda: patch_sample.sample_patch3(img, su, sv))
        b_ms = k1_bound(img, su, sv)[0]
        sweep.append({"N": n, "kernel_ms": k_ms, "bound_ms": b_ms,
                      "bound_share": b_ms / k_ms})
    log("K1 sweep: " + json.dumps({"T": 8, "K": 8, "floor_ms": floor_ms,
                                   "points": sweep}))
    return {
        "name": "K1_patch_sample3", "route": "cuda",
        "source": "dmvio_tpu_torch/csrc/patch_sample.cu",
        "replaces": "dmvio_tpu/ops/patch_sample.py:98",
        "max_abs_err": err, "max_err": err, "ok_equal": True,
        "ms": ms, "kernel_ms": ms, "call_ms": kernel_call_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms, "bound_share": bound_ms / ms,
        "floor_ms": floor_ms,
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


def vio_inputs(dev, n_frames=None):
    """bench.py's VIO sequence on `dev` (VIO_FRAMES frames by default):
    rendered frames, IMU chunks per frame, ground-truth metric body
    poses."""
    n = VIO_FRAMES if n_frames is None else n_frames
    seq = synthetic.generate_vio_sequence(
        n_frames=n, h=H, w=W, scene=synthetic.default_scene(2.0, device=dev),
        **VIO_SEQ)
    spf = seq["steps_per_frame"]
    chunks = [None] + [
        (seq["acc"][(i - 1) * spf:i * spf], seq["gyr"][(i - 1) * spf:i * spf],
         np.full(spf, seq["imu_dt"], np.float32))
        for i in range(1, n)]
    gt = [(float(seq["timestamps"][i]), np.asarray(seq["R_body"][i]),
           seq["p_gt"][i]) for i in range(n)]
    return seq, chunks, gt


def vio_scores(fs, gt):
    """(all poses finite, se3 ATE, sim3 ATE, path length) of the metric
    trajectory from first_kf + 5 on, as tests/test_full_vio.py scores it."""
    est = fs.metric_trajectory()
    if est is None or len(est) != len(gt):
        raise AssertionError("VIO: no metric trajectory for every frame")
    finite = all(np.all(np.isfinite(p[1])) and np.all(np.isfinite(p[2]))
                 for p in est)
    first_kf = min(fs.kf_poses.keys())
    keep = [k for k, sh in enumerate(fs.shells)
            if sh.frame_id >= first_kf + 5]
    est_t = [est[k] for k in keep]
    gt_t = [gt[k] for k in keep]
    dist = trajectory.path_length(np.stack([g[2] for g in gt_t]))
    return (finite, trajectory.ate_rmse(est_t, gt_t, with_scale=False),
            trajectory.ate_rmse(est_t, gt_t, with_scale=True), dist)


def phase_vio(dev):
    seq, chunks, gt = vio_inputs(dev)
    cfg = window.Config(**CFG)
    fs = full_system.FullSystem(seq["calib"], H, W, cfg,
                                imu_calib=imu_system.IMUCalib())
    torch.cuda.synchronize()
    timing.reset()
    patch_sample.sample_patch3.launches = 0
    active_at = pgba_at = None
    t0 = time.perf_counter()
    for i in range(VIO_FRAMES):
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunks[i])
        if active_at is None and fs.imu.phase == imu_system.ACTIVE:
            active_at = i
        if pgba_at is None and fs.imu.pgba_count >= 1:
            pgba_at = i
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = patch_sample.sample_patch3.launches

    finite, se3, sim3, dist = vio_scores(fs, gt)
    gate_se3 = max(0.08 * dist + 0.01, 1.5 * REF_VIO_SE3)
    gate_sim3 = max(0.04 * dist + 0.01, 1.5 * REF_VIO_SIM3)
    stats = timing.get_stats()
    stages = {k: v["median"] * 1e3 for k, v in stats.items()}
    totals = {k: [v["n"], v["n"] * v["mean"]] for k, v in stats.items()}
    summary = {
        "frames": VIO_FRAMES, "keyframes": fs.stats_kf,
        "resets": fs.stats_resets, "lost_frames": fs.stats_lost_frames,
        "active_at_frame": active_at, "first_pgba_at_frame": pgba_at,
        "pgba_count": fs.imu.pgba_count,
        "pgba_adopted": fs.imu.pgba_adopt_count,
        "scale": float(np.exp(fs.imu.states.s_log.item())),
        "wall_s": wall, "fps": VIO_FRAMES / wall, "ate_se3": se3,
        "ate_sim3": sim3, "path_length": dist, "gate_se3": gate_se3,
        "gate_sim3": gate_sim3, "k1_launches": launches,
        "stage_median_ms": stages, "stage_calls_total_s": totals,
    }
    log("VIO path: " + json.dumps(summary))
    checks = [
        (fs.imu.phase == imu_system.ACTIVE, f"IMU phase {fs.imu.phase}"),
        (fs.imu.pgba_count >= 1, "no PGBA cycle completed"),
        (fs.stats_resets == 0, f"{fs.stats_resets} resets"),
        (fs.stats_lost_frames <= 2, f"{fs.stats_lost_frames} lost frames"),
        (finite, "non-finite pose in the metric trajectory"),
        (launches > 0, "K1 was never launched on the VIO path"),
        (math.isfinite(se3) and se3 < gate_se3,
         f"se3 ATE {se3} >= gate {gate_se3}"),
        (math.isfinite(sim3) and sim3 < gate_sim3,
         f"sim3 ATE {sim3} >= gate {gate_sim3}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError("VIO path: " + msg)
    return launches


# ---------------------------------------------------------------------------
# Realtime pipeline
# ---------------------------------------------------------------------------


class SyncCounter:
    """Counts the host syncs PyTorch reports in its CUDA sync debug mode
    ("warn": item() and bool() of a device tensor, blocking copies either
    way, ...) while active. The fetcher's waits on its CUDA events are not
    among them: those are the pipeline's intended sync points, timed as
    track_fetch, kf_finalize_fetch and kf_decision_wait."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False

    def take(self) -> int:
        """Syncs since the last call."""
        n = sum(1 for w in self._records if "synchroniz" in str(w.message))
        del self._records[:]
        return n


def pgba_running(fs) -> bool:
    bg = fs.imu._pgba_bg if fs.imu is not None else None
    return bg is not None and bg["thread"].is_alive()


def run_realtime(fs, frames, timestamps, chunks):
    """Feed the frames through the realtime pipeline and flush it with
    finish(); K1's launch count and the stage timers are set to 0 just
    before. Host syncs are counted over the last SYNC_WINDOW frames and
    the flush (counting slows the host, so the frames before the window
    give an uncounted frames/s too). Returns K1's launches and the
    pipeline's numbers."""
    torch.cuda.synchronize()
    timing.reset()
    patch_sample.sample_patch3.launches = 0
    frame_s, window_syncs, pgba_busy = [], [], []
    depth = 0
    init_at = active_at = pgba_at = None
    w0 = len(frames) - SYNC_WINDOW
    syncs = SyncCounter()
    t0 = t_w0 = time.perf_counter()
    try:
        for i, img in enumerate(frames):
            if i == w0:
                t_w0 = time.perf_counter()
                syncs.__enter__()
            busy = pgba_running(fs)
            t = time.perf_counter()
            fs.add_frame(img, timestamps[i], imu_data=chunks[i])
            frame_s.append(time.perf_counter() - t)
            pgba_busy.append(busy or pgba_running(fs))
            depth = max(depth, len(fs._rt_queue))
            if i >= w0:
                window_syncs.append(syncs.take())
            if init_at is None and fs.initialized:
                init_at = i
            if fs.imu is not None:
                if active_at is None and fs.imu.phase == imu_system.ACTIVE:
                    active_at = i
                if pgba_at is None and fs.imu.pgba_count >= 1:
                    pgba_at = i
        fs.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finish_syncs = syncs.take()
    finally:
        syncs.__exit__(None, None, None)
    launches = patch_sample.sample_patch3.launches
    stats = timing.get_stats()
    tracked = range(init_at + 1 if init_at is not None else len(frames),
                    len(frames))

    def mean_ms(idx):
        idx = list(idx)
        return 1e3 * statistics.fmean(frame_s[k] for k in idx) if idx \
            else None
    waits = {k: {"n": v["n"], "total_s": v["n"] * v["mean"],
                 "median_ms": v["median"] * 1e3, "max_ms": v["max"] * 1e3}
             for k, v in stats.items()
             if k in ("track_fetch", "kf_finalize_fetch", "kf_decision_wait",
                      "kf_stretch_block", "pgba_thread", "pgba_snapshot")}
    return launches, {
        "frames": len(frames), "wall_s": wall, "fps": len(frames) / wall,
        "fps_before_sync_window": w0 / (t_w0 - t0),
        "initialized_at_frame": init_at, "active_at_frame": active_at,
        "first_pgba_at_frame": pgba_at,
        "frame_ms_median": 1e3 * statistics.median(frame_s),
        "stage_median_ms": {k: v["median"] * 1e3 for k, v in stats.items()},
        "stage_calls_total_s": {k: [v["n"], v["n"] * v["mean"]]
                                for k, v in stats.items()},
        "waits": waits, "max_in_flight": depth,
        "sync_window_frames": SYNC_WINDOW,
        "host_syncs_per_frame": statistics.fmean(window_syncs),
        "host_syncs_per_frame_max": max(window_syncs),
        "host_syncs_finish": finish_syncs,
        "frame_ms_mean_pgba_thread_running": mean_ms(
            k for k in tracked if pgba_busy[k]),
        "frame_ms_mean_pgba_thread_idle": mean_ms(
            k for k in tracked if not pgba_busy[k]),
        "k1_launches": launches,
    }


def phase_rt_vo(dev):
    calib, frames, gt = main_path_inputs(dev)
    cfg = window.Config(**RT_CFG)
    fs = full_system.FullSystem(calib, H, W, cfg)           # device: cuda
    launches, summary = run_realtime(
        fs, frames, [i * 0.05 for i in range(N_FRAMES)],
        [None] * N_FRAMES)
    est = fs.trajectory()
    if len(est) != N_FRAMES:
        raise AssertionError(f"rt-vo: {len(est)} poses for {N_FRAMES} "
                             "frames")
    finite = all(np.all(np.isfinite(p[1])) and np.all(np.isfinite(p[2]))
                 for p in est)
    ate = trajectory.ate_rmse(est, gt, with_scale=True)
    path = trajectory.path_length(np.stack([g[2] for g in gt]))
    gate = max(0.03 * path, 1.5 * REF_RT_ATE_SIM3)
    summary.update(keyframes=fs.stats_kf, resets=fs.stats_resets,
                   lost_frames=fs.stats_lost_frames, ate_sim3=ate,
                   path_length=path, ate_gate=gate)
    log("rt-vo-512: " + json.dumps(summary))
    checks = [
        (fs.initialized, "not initialized"),
        (not fs.is_lost, "lost at the end"),
        (fs.stats_resets == 0, f"{fs.stats_resets} resets"),
        (fs.stats_kf >= RT_VO_MIN_KEYFRAMES,
         f"only {fs.stats_kf} keyframes"),
        (finite, "non-finite pose in the trajectory"),
        (launches > 0, "K1 was never launched on the realtime VO path"),
        (math.isfinite(ate) and ate < gate, f"ATE {ate} >= gate {gate}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError("rt-vo-512: " + msg)
    return launches


def phase_rt_vio(dev):
    seq, chunks, gt = vio_inputs(dev, RT_VIO_FRAMES)
    cfg = window.Config(**RT_CFG)
    fs = full_system.FullSystem(seq["calib"], H, W, cfg,
                                imu_calib=imu_system.IMUCalib())
    launches, summary = run_realtime(
        fs, seq["images"], [float(x) for x in seq["timestamps"]], chunks)
    finite, se3, sim3, dist = vio_scores(fs, gt)
    gate_se3 = max(0.08 * dist + 0.01, 1.5 * REF_RT_VIO_SE3)
    gate_sim3 = max(0.04 * dist + 0.01, 1.5 * REF_RT_VIO_SIM3)
    summary.update(
        keyframes=fs.stats_kf, resets=fs.stats_resets,
        lost_frames=fs.stats_lost_frames, imu_phase=fs.imu.phase,
        pgba_count=fs.imu.pgba_count, pgba_adopted=fs.imu.pgba_adopt_count,
        scale=float(np.exp(fs.imu.states.s_log.item())),
        ate_se3=se3, ate_sim3=sim3, path_length=dist, gate_se3=gate_se3,
        gate_sim3=gate_sim3)
    log("rt-vio-512: " + json.dumps(summary))
    checks = [
        (fs.imu.phase == imu_system.ACTIVE, f"IMU phase {fs.imu.phase}"),
        (fs.stats_resets == 0, f"{fs.stats_resets} resets"),
        (fs.stats_lost_frames <= 2, f"{fs.stats_lost_frames} lost frames"),
        (finite, "non-finite pose in the metric trajectory"),
        (launches > 0, "K1 was never launched on the realtime VIO path"),
        (math.isfinite(se3) and se3 < gate_se3,
         f"se3 ATE {se3} >= gate {gate_se3}"),
        (math.isfinite(sim3) and sim3 < gate_sim3,
         f"sim3 ATE {sim3} >= gate {gate_sim3}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError("rt-vio-512: " + msg)
    return launches


# ---------------------------------------------------------------------------
# Dataset CLI
# ---------------------------------------------------------------------------


def phase_cli(dev):
    """cli-vio-512: the port's make_synthetic writes the dataset on `dev`,
    then run_dataset.run drives it in-process with K1's count and the
    stage timers set to 0 just before."""
    import shutil

    shutil.rmtree(CLI_DATA, ignore_errors=True)
    shutil.rmtree(CLI_OUT, ignore_errors=True)
    os.makedirs(CLI_OUT)
    t0 = time.perf_counter()
    make_synthetic.main([f"out={CLI_DATA}", f"n={CLI_FRAMES}", *CLI_SYNTH,
                         f"device={dev}"])
    synth_s = time.perf_counter() - t0
    d = CLI_DATA
    argv = [f"files={d}/images", f"calib={d}/camera.txt",
            f"tsFile={d}/times.txt", f"imuFile={d}/imu.txt",
            f"gammaCalib={d}/pcalib.txt", f"vignette={d}/vignette.png",
            *CLI_ARGS, f"resultsPrefix={CLI_OUT}", f"device={dev}"]
    torch.cuda.synchronize()
    timing.reset()
    patch_sample.sample_patch3.launches = 0
    t0 = time.perf_counter()
    summary = run_dataset.run(argv)
    wall = time.perf_counter() - t0
    launches = patch_sample.sample_patch3.launches
    stats = timing.get_stats()
    load = stats.get("load_image", {"mean": math.nan, "median": math.nan})

    missing = [f for f in CLI_FILES
               if not os.path.exists(CLI_OUT + f)
               or os.path.getsize(CLI_OUT + f) == 0]
    gt = trajectory.read_tum(os.path.join(d, "gt.csv"))
    est = trajectory.read_tum(CLI_OUT + "result.txt") \
        if "result.txt" not in missing else []
    est_s = trajectory.read_tum(CLI_OUT + "resultScaled.txt") \
        if "resultScaled.txt" not in missing else []
    finite = all(np.all(np.isfinite(p[1])) and np.all(np.isfinite(p[2]))
                 for p in est + est_s)
    dist = trajectory.path_length(np.stack([g[2] for g in gt]))
    sim3 = trajectory.ate_rmse(est, gt[:len(est)]) if est else math.inf
    se3 = trajectory.ate_rmse(est_s, gt[:len(est_s)], with_scale=False) \
        if est_s else math.inf
    gate_sim3 = max(0.04 * dist + 0.01, 1.5 * REF_CLI_SIM3)
    gate_se3 = max(0.10 * dist + 0.01, 1.5 * REF_CLI_SE3)
    out = dict(summary)
    out.update(
        synth_s=synth_s, cli_wall_s=wall, fps_whole_cli=CLI_FRAMES / wall,
        load_ms_per_frame_mean=load["mean"] * 1e3,
        load_ms_per_frame_median=load["median"] * 1e3,
        frame_ms_median=stats["frame_total"]["median"] * 1e3,
        ate_sim3=sim3, ate_se3=se3, path_length=dist, gate_sim3=gate_sim3,
        gate_se3=gate_se3, k1_launches=launches, missing_files=missing,
        stage_median_ms={k: v["median"] * 1e3 for k, v in stats.items()})
    log("cli-vio-512: " + json.dumps(out))
    checks = [
        (summary["native_loader"], "the native loader did not start"),
        (not missing, f"missing or empty outputs: {missing}"),
        (summary["frames"] == CLI_FRAMES and len(est) == CLI_FRAMES,
         f"{len(est)} poses for {CLI_FRAMES} frames"),
        (summary["imu_phase"] == imu_system.ACTIVE,
         f"IMU phase {summary['imu_phase']}"),
        (summary["pgba_count"] >= 1, "no PGBA cycle completed"),
        (summary["resets"] == 0, f"{summary['resets']} resets"),
        (summary["lost_frames"] <= 2, f"{summary['lost_frames']} lost"),
        (finite, "non-finite pose in the results"),
        (launches > 0, "K1 was never launched on the CLI path"),
        (math.isfinite(sim3) and sim3 < gate_sim3,
         f"sim3 ATE {sim3} >= gate {gate_sim3}"),
        (math.isfinite(se3) and se3 < gate_se3,
         f"se3 ATE {se3} >= gate {gate_se3}"),
    ]
    for ok, msg in checks:
        if not ok:
            raise AssertionError("cli-vio-512: " + msg)
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
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"native loader: {native.load_error()}")
    log(f"built the native loader ({native.LIB.name}) in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log("patch_sample").splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    k1 = phase_kernels(dev)
    k1["launches_main_path"] = phase_main_path(dev)
    k1["launches_vio_path"] = phase_vio(dev)
    k1["launches_rt_vo_path"] = phase_rt_vo(dev)
    k1["launches_rt_vio_path"] = phase_rt_vio(dev)
    k1["launches_cli_path"] = phase_cli(dev)
    log(f"K1 launches: VO path {k1['launches_main_path']}, VIO path "
        f"{k1['launches_vio_path']}, realtime VO path "
        f"{k1['launches_rt_vo_path']}, realtime VIO path "
        f"{k1['launches_rt_vio_path']}, CLI path "
        f"{k1['launches_cli_path']}")
    k1["launches"] = (k1["launches_main_path"] + k1["launches_vio_path"]
                      + k1["launches_rt_vo_path"]
                      + k1["launches_rt_vio_path"]
                      + k1["launches_cli_path"])
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
