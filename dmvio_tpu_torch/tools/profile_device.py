"""Device time per pipeline stage, kernel by kernel.

Counterpart of dmvio_tpu/tools/profile_device.py, on torch.profiler. Runs
the synthetic VIO benchmark sequence (bench.py's: seed 2, 512x512 by
default) through FullSystem to a steady state, then runs each stage once
more outside the trace (warm-up) and once under torch.profiler, and
prints its device total and its top kernels:

  pyramid, track (the 4-candidate ladder against the tracker reference),
  trace (the immature pool's epipolar search), activate, ba (the window
  BA, kernel K1 in every linearization), marg (the fused marginalization
  tail), tref (the tracker reference build);
  with --vio, after the IMU is ACTIVE: vio_ba and vio_tail.

On the card the device total is the sum of the CUDA kernels, copies and
memsets the stage ran; with device=cpu there is no device, and the total
printed is the CPU operators' own time ("cpu op total"), which says
nothing about the card. mesh=N profiles the point-axis stages (ba, marg,
vio_ba, vio_tail) over N shards of the one device (dist_ba.Placer).

Usage:
    python -m dmvio_tpu_torch.tools.profile_device [--vio] [stage ...] \
        [H=512 W=512 frames=40 seed=2 mesh=N device=cpu \
         <window.Config field>=<value> ...]
"""

from __future__ import annotations

import collections
import dataclasses
import sys

import numpy as np
import torch
from torch.autograd import DeviceType

VO_STAGES = ("pyramid", "track", "trace", "activate", "ba", "marg", "tref")
VIO_STAGES = ("vio_ba", "vio_tail")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_stage(name: str, fn, dev, top: int = 10) -> dict:
    """Run `fn` once to warm up and once under torch.profiler; print and
    return the stage's total and its top kernels."""
    fn()
    _sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        _sync(dev)
    per = collections.defaultdict(lambda: [0.0, 0])
    if dev.type == "cuda":
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name][0] += e.time_range.elapsed_us()
                per[e.name][1] += 1
        label = "device total"
    else:
        for e in prof.key_averages():
            per[e.key][0] += e.self_cpu_time_total
            per[e.key][1] += e.count
        label = "cpu op total"
    rows = sorted(per.items(), key=lambda kv: -kv[1][0])
    total_ms = sum(us for us, _ in per.values()) / 1e3
    print(f"== {name}  ({label} {total_ms:.3f} ms)")
    for k, (us, n) in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms x{n:5d}  {k[:78]}", flush=True)
    return {"stage": name, "total_ms": total_ms, "label": label,
            "top": [(k, us / 1e3, n) for k, (us, n) in rows[:top]]}


def steady_state(H, W, n_frames, seed, cfg, dev, vio):
    """The VIO benchmark sequence through FullSystem (with the IMU for
    --vio); returns the system and the frames past the fed ones."""
    from dmvio_tpu_torch.models import full_system, imu_system
    from dmvio_tpu_torch.utils import synthetic

    seq = synthetic.generate_vio_sequence(
        n_frames=n_frames + 2, frame_dt=0.05, h=H, w=W, s_dso=1.3,
        g2=(0.05, -0.03), accel_scale=0.5, rot_scale=0.3, seed=seed,
        scene=synthetic.default_scene(2.0, device=dev))
    fs = full_system.FullSystem(
        seq["calib"], H, W, cfg, device=dev,
        imu_calib=imu_system.IMUCalib() if vio else None)
    spf = seq["steps_per_frame"]
    for i in range(n_frames):
        chunk = None
        if vio and i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
    return fs, seq["images"][n_frames:]


def main(argv=None) -> list:
    import dmvio_tpu_torch
    from dmvio_tpu_torch.models import imu_system, window
    from dmvio_tpu_torch.ops import pyramid
    from dmvio_tpu_torch.parallel import dist_ba

    args = list(argv if argv is not None else sys.argv[1:])
    vio = "--vio" in args
    kv = dict(a.split("=", 1) for a in args if "=" in a)
    names = [a for a in args if "=" not in a and not a.startswith("--")]
    want = names or list(VIO_STAGES if vio else VO_STAGES)
    dev = dmvio_tpu_torch.device(kv.pop("device", None))
    H, W = int(kv.pop("H", 512)), int(kv.pop("W", 512))
    n_frames = int(kv.pop("frames", 60 if vio else 36))
    seed = int(kv.pop("seed", 2))
    mesh = int(kv.pop("mesh", 0))
    cfg = window.Config(f_max=8, p_max=2048, i_max=2048, max_frames=7,
                        levels=6, ba_iters=6, realtime=False)
    types = {f.name: getattr(f.type, "__name__", f.type)
             for f in dataclasses.fields(cfg)}
    cast = {"int": int, "float": float, "bool": lambda s: s == "1"}
    for k, v in kv.items():
        setattr(cfg, k, cast[types[k]](v))

    fs, spare = steady_state(H, W, n_frames, seed, cfg, dev, vio)
    print(f"steady state on {dev}: {fs.stats_kf} keyframes, "
          f"{fs._n_active:.0f} active points, imu phase "
          f"{fs.imu.phase if fs.imu is not None else None}", flush=True)
    if vio and fs.imu.phase != imu_system.ACTIVE:
        raise RuntimeError("the IMU never became ACTIVE")
    if not fs.initialized or fs.ref_kf_slot < 0:
        raise RuntimeError("the system never initialized")
    if mesh > 1:
        fs.placer = dist_ba.Placer([dev] * mesh, home=dev)
    slot = fs.ref_kf_slot
    levels = fs.cfg.levels
    pyr = tuple(pyramid.build_pyramid(spare[0], levels=levels))
    eye = np.eye(3, dtype=np.float32)
    R_c = np.stack([eye] * 4)
    t_c = np.zeros((4, 3), np.float32)
    m_c = np.array([True, True, False, False])
    R_cw = torch.eye(3, device=dev)
    t_cw = torch.zeros(3, device=dev)
    aff = torch.zeros(2, device=dev)
    stages = {
        "pyramid": lambda: pyramid.build_pyramid(spare[1], levels=levels),
        "track": lambda: fs._track_dispatch(pyr, R_c, t_c, m_c,
                                            fs.last_rho, fs.last_b),
        "trace": lambda: fs._trace_pool(R_cw, t_cw, aff, pyr),
        "activate": lambda: fs._activate_points(slot),
        "ba": lambda: fs._run_ba(max_iters=fs.cfg.ba_iters),
        "marg": lambda: fs._dispatch_marg_fused(slot),
        "tref": lambda: fs._build_tracker_ref_dev(slot),
        "vio_ba": lambda: fs._run_ba(max_iters=fs.cfg.ba_iters),
        "vio_tail": lambda: fs._dispatch_vio_tail(slot),
    }
    out = []
    for name in want:
        if name not in stages:
            raise SystemExit(f"unknown stage {name!r} (known: "
                             f"{', '.join(stages)})")
        out.append(profile_stage(name, stages[name], dev))
    return out


if __name__ == "__main__":
    main()
