"""Where the time goes on the port's main paths, on one CUDA device.

Drives the same sequence as chip_smoke.py's VO phase (serial visual
odometry, 512x512, Config(f_max=8, p_max=2048, ...)) or, with --vio, its
VIO phase (bench.py's VIO sequence with the IMU, 60 frames; 120 with --rt,
as the smoke's rt-vio-512 phase) once unprofiled, for the wall clock, and
once with its last 10 frames (tracking and keyframes in steady state;
ACTIVE VIO for --vio) under torch.profiler, for the device side. With --rt the same runs go through the realtime
pipeline (Config realtime=True, rt_* defaults, async_fetch on), and the
profiled window ends with finish(). Prints one JSON line: card, wall-clock
frames/s, device busy time of the last 10 frames (the sum of kernel and
copy times on the single stream), the device's idle share of those
frames' unprofiled wall time, kernel launches, host syncs (aten::item /
_local_scalar_dense, device-to-host copies, and the CUDA runtime's
synchronize calls, which include every blocking copy either way), K1's
share, and the ops that take the most device time. Device time by kernel
goes to profile_{main,vio}_path.txt (profile_rt_{main,vio}_path.txt with
--rt) in the output directory that main() names.

    python3 tools/profile_main_path.py [--rt] [--vio]

Imports nothing of JAX or of the JAX package; needs a CUDA device.
"""

import collections
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dmvio_tpu_torch.models import full_system, imu_system  # noqa: E402
from dmvio_tpu_torch.models import window  # noqa: E402
from dmvio_tpu_torch.utils import timing  # noqa: E402


def run(calib, frames, n_tail: int = 0, profile: bool = False,
        chunks=None, rt: bool = False):
    """Feed `frames` (with the IMU `chunks` per frame, if given) to a fresh
    FullSystem, realtime if `rt` (flushed with finish()). Returns the
    system, the wall time of the whole run and of its last `n_tail` frames,
    and the profiler that recorded those last frames (if `profile`)."""
    cfg = chip_smoke.RT_CFG if rt else chip_smoke.CFG
    fs = full_system.FullSystem(
        calib, chip_smoke.H, chip_smoke.W, window.Config(**cfg),
        imu_calib=imu_system.IMUCalib() if chunks else None)
    torch.cuda.synchronize()
    timing.reset()
    start = len(frames) - n_tail
    prof = None
    t0 = t_tail = time.perf_counter()
    for i, img in enumerate(frames):
        if n_tail and i == start:
            torch.cuda.synchronize()
            if profile:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t_tail = time.perf_counter()
        fs.add_frame(img, timestamp=i * 0.05,
                     imu_data=chunks[i] if chunks else None)
    fs.finish()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    return fs, t1 - t0, t1 - t_tail, prof


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    vio = "--vio" in sys.argv[1:]
    rt = "--rt" in sys.argv[1:]
    chunks = None
    if vio:
        seq, chunks, _ = chip_smoke.vio_inputs(
            dev, chip_smoke.RT_VIO_FRAMES if rt else None)
        calib, frames = seq["calib"], seq["images"]
    else:
        calib, frames, _ = chip_smoke.main_path_inputs(dev)
    n_tail = 10          # steady state: tracking and 3-4 keyframes
    run(calib, frames[:8], chunks=chunks, rt=rt)         # warm-up: caches
    fs, wall, wall_tail, _ = run(calib, frames, n_tail, chunks=chunks,
                                 rt=rt)
    stages = {k: v["median"] * 1e3 for k, v in timing.get_stats().items()}
    print(f"unprofiled: {len(frames)} frames in {wall:.3f} s, the last "
          f"{n_tail} in {wall_tail:.3f} s", flush=True)
    t0 = time.perf_counter()
    _, _, wall_prof, prof = run(calib, frames, n_tail, profile=True,
                                chunks=chunks, rt=rt)
    print(f"profiled the last {n_tail} frames ({wall_prof:.3f} s); run "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    # Device-side events (kernels, copies, memsets) on the one stream, and
    # counts of the host-side events that launch or wait.
    per_name = collections.defaultdict(lambda: [0.0, 0])
    counts = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += e.time_range.elapsed_us()
            per_name[e.name][1] += 1
        else:
            counts[e.name] += 1
    rows = sorted(((k, us, c) for k, (us, c) in per_name.items()),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    syncs = counts["aten::_local_scalar_dense"]
    d2h = sum(c for k, us, c in rows if "DtoH" in k)
    launches = counts["cudaLaunchKernel"] + counts["cuLaunchKernel"]
    cuda_syncs = {k: c for k, c in counts.items() if "Synchronize" in k}
    k1_us = sum(r[1] for r in rows if "patch_sample3" in r[0])
    print(f"read the trace in {time.perf_counter() - t0:.1f} s", flush=True)
    top = [{"op": k[:80], "device_ms": us / 1e3, "calls": c}
           for k, us, c in rows[:12]]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = ("profile_rt_" if rt else "profile_") \
        + ("vio_path.txt" if vio else "main_path.txt")
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(card + "\n")
        for k, us, c in rows:
            f.write(f"{us / 1e3:12.3f} ms {c:8d}  {k}\n")
    print(json.dumps({
        "card": card, "path": ("rt-" if rt else "") + ("vio" if vio else "vo"),
        "frames": len(frames), "keyframes": fs.stats_kf,
        "wall_s": wall, "fps": len(frames) / wall,
        "stage_median_ms": stages,
        "tail_frames": n_tail, "tail_wall_s": wall_tail,
        "profiled_tail_wall_s": wall_prof,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_tail,
        "kernel_launches": launches, "host_syncs_item": syncs,
        "memcpy_dtoh": d2h, "cuda_synchronize_calls": cuda_syncs,
        "k1_device_ms": k1_us / 1e3, "top_ops": top,
    }))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
