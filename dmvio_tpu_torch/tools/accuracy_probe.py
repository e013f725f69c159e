"""Accuracy probe: the VIO pipeline's ATE over seeds, excitations and
devices.

Counterpart of dmvio_tpu/tools/accuracy_probe.py. Runs the full serial
(or realtime) VIO pipeline on the hard synthetic fixture of
tests/test_full_vio.py (192x256, 48 frames, aggressive motion) over a
grid of (seed, excitation, device) and prints one JSON record per run:
sim3/se3 ATE in % of the whole path over all frames and from the first
keyframe + 5 on (the tail the tests gate), the tail's share of the
tests' gates, and the estimator internals that separate
the chaotic basins (activation frame, PGBA cycles and adoptions, scale
variances, final scale, keyframes, lost frames). The reference's axis of
XLA virtual device counts (its codegen moves the basins) becomes a device
axis here: the same configuration on the CPU and on the card. Every
configuration runs in a subprocess of its own, so the runs share no
state.

Usage:
    python -m dmvio_tpu_torch.tools.accuracy_probe seeds=3,5,7 \
        excite=0,2.0 device=cpu,cuda [frames=48] [realtime=0] \
        [h=192 w=256] [threads=N] [json=out.jsonl]

Worker mode: worker=1 and one configuration (seed=, excite=, device=);
prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
# The reference's record, with its device count replaced by the device,
# and the tail's share of the tests' gates.
FIELDS = ("seed", "excite", "frames", "realtime", "device", "phase",
          "act_fid", "pgba", "adopt", "svar", "init_svar", "kf", "lost",
          "s_est", "sim3_full", "se3_full", "sim3_tail", "se3_tail",
          "sim3_gate_share", "se3_gate_share")


def _parse_args(argv):
    return dict(a.split("=", 1) for a in argv if "=" in a)


def run_worker(kv) -> dict:
    import numpy as np
    import torch

    import dmvio_tpu_torch
    from dmvio_tpu_torch.models import full_system, imu_system, window
    from dmvio_tpu_torch.utils import synthetic, trajectory

    if "threads" in kv:
        torch.set_num_threads(int(kv["threads"]))
    dev = dmvio_tpu_torch.device(kv.get("device"))
    seed = int(kv.get("seed", 3))
    excite = float(kv.get("excite", 0.0))
    n = int(kv.get("frames", 48))
    rt = bool(int(kv.get("realtime", 0)))
    h, w = int(kv.get("h", 192)), int(kv.get("w", 256))
    seq = synthetic.generate_vio_sequence(
        n_frames=n, frame_dt=0.05, h=h, w=w,
        s_dso=1.4, g2=(0.06, -0.04), accel_scale=0.8, rot_scale=0.45,
        seed=seed, excite=excite,
        scene=synthetic.default_scene(2.0, device=dev))
    cfg = window.Config(f_max=6, p_max=512, i_max=512, max_frames=4,
                        levels=4, ba_iters=6, realtime=rt,
                        async_fetch=False)
    fs = full_system.FullSystem(
        seq["calib"], h, w, cfg, device=dev,
        imu_calib=imu_system.IMUCalib(
            pgba_scale_th=float(kv.get("pgba_th", 1.0))))
    if rt:
        fs.imu.pgba_background = False      # repeatable
    spf = seq["steps_per_frame"]
    act_fid = None
    for i in range(n):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
        if act_fid is None and fs.imu.phase == imu_system.ACTIVE:
            act_fid = i
    fs.finish()

    def num(x):
        return round(float(x), 6) if x is not None else float("nan")

    rec = dict(seed=seed, excite=excite, frames=n, realtime=int(rt),
               device=dev.type, phase=int(fs.imu.phase), act_fid=act_fid,
               pgba=int(fs.imu.pgba_count), adopt=int(fs.imu.pgba_adopt_count),
               svar=num(fs.imu.last_pgba_svar),
               init_svar=num(fs.imu.init_s_var), kf=fs.stats_kf,
               lost=fs.stats_lost_frames)
    est = fs.metric_trajectory()
    if est is None:
        rec["error"] = "imu never activated"
        return rec
    rec["s_est"] = round(float(torch.exp(fs.imu.states.s_log)), 4)
    gt = [(float(seq["timestamps"][i]), np.asarray(seq["R_body"][i]),
           seq["p_gt"][i]) for i in range(n)]
    first_kf = min(fs.kf_poses.keys())

    def path(g):
        return float(np.sum(np.linalg.norm(
            np.diff(np.stack([x[2] for x in g]), axis=0), axis=1)))

    def ate(lo):
        e = [x for x, sh in zip(est, fs.shells) if sh.frame_id >= lo]
        g = [x for x, sh in zip(gt, fs.shells) if sh.frame_id >= lo]
        return (trajectory.ate_rmse(e, g, with_scale=True),
                trajectory.ate_rmse(e, g, with_scale=False), path(g))

    dist = path(gt)
    for part, lo in (("full", 0), ("tail", first_kf + 5)):
        sim3, se3, _ = ate(lo)
        rec[f"sim3_{part}"] = round(100 * sim3 / dist, 3)
        rec[f"se3_{part}"] = round(100 * se3 / dist, 3)
    # The tail against tests/test_full_vio.py's gates (0.04 / 0.08 of the
    # tail's own path, + 1 cm): the share of its gate each ATE uses.
    sim3, se3, d_tail = ate(first_kf + 5)
    rec["sim3_gate_share"] = round(sim3 / (0.04 * d_tail + 0.01), 4)
    rec["se3_gate_share"] = round(se3 / (0.08 * d_tail + 0.01), 4)
    return rec


def main(argv=None) -> list:
    kv = _parse_args(argv if argv is not None else sys.argv[1:])
    if int(kv.get("worker", 0)):
        rec = run_worker(kv)
        print(json.dumps(rec), flush=True)
        return [rec]
    seeds = [int(s) for s in str(kv.get("seeds", "3,5,7")).split(",")]
    excites = [float(x) for x in str(kv.get("excite", "0,2.0")).split(",")]
    devices = str(kv.get("device", "cpu,cuda")).split(",")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    rows = []
    for dev in devices:
        for ex in excites:
            for seed in seeds:
                args = [sys.executable, "-m",
                        "dmvio_tpu_torch.tools.accuracy_probe", "worker=1",
                        f"seed={seed}", f"excite={ex}", f"device={dev}"]
                for k in ("frames", "realtime", "h", "w", "pgba_th",
                          "threads"):
                    if k in kv:
                        args.append(f"{k}={kv[k]}")
                r = subprocess.run(args, capture_output=True, text=True,
                                   env=env, cwd=_REPO, timeout=3600)
                line = (r.stdout.strip().splitlines() or ["{}"])[-1]
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    rec = {"seed": seed, "excite": ex, "device": dev,
                           "error": (r.stderr.strip().splitlines()
                                     or ["no output"])[-1][:200]}
                rows.append(rec)
                print(json.dumps(rec), flush=True)
    if kv.get("json"):
        with open(kv["json"], "w") as f:
            for rec in rows:
                f.write(json.dumps(rec) + "\n")
    print(f"{'device':>6} {'ex':>4} {'seed':>4} {'act':>4} {'pgba':>4} "
          f"{'adpt':>4} {'s_est':>7} {'sim3%':>7} {'se3%':>7} "
          f"{'se3_tail%':>9} {'se3/gate':>8}", file=sys.stderr)
    for r in rows:
        if "error" in r:
            print(f"{r.get('device', '?'):>6} {r.get('excite', '?'):>4} "
                  f"{r.get('seed', '?'):>4} ERROR {r['error']}",
                  file=sys.stderr)
            continue
        print(f"{r['device']:>6} {r['excite']:>4} {r['seed']:>4} "
              f"{str(r['act_fid']):>4} {r['pgba']:>4} {r['adopt']:>4} "
              f"{r['s_est']:>7} {r['sim3_full']:>7} {r['se3_full']:>7} "
              f"{r['se3_tail']:>9} {r['se3_gate_share']:>8}",
              file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
