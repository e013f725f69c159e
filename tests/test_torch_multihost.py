"""Multi-process execution of the port's sharded BA, as
tests/test_multihost.py holds the reference: two processes join one
torch.distributed gloo group through parallel/dist_init (the DMVIO_*
variables), each holds 2 shards of the CPU, so the mesh is (2, 2) with
the rank on its first axis, and the camera-sized sums and per-point
gathers of every window BA cross the process boundary.

Both ranks run the real pipeline (the seed-3 VIO sequence, 128x160, 36
frames, the reference worker's Config) and must each initialize, make at
least 6 keyframes, lose no frame, give at least 30 poses and stay under
5% of path in sim3 ATE; and, running the same host pipeline on the same
collectives, agree bit for bit.

This file is also the worker: `python tests/test_torch_multihost.py
<rank> <port>` runs one rank and prints its MHRESULT line.
"""

import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 600


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pipeline():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("DMVIO_COORDINATOR", "DMVIO_NUM_PROCESSES",
              "DMVIO_PROCESS_ID", "DMVIO_DIST"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(pid), str(port)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    deadline = time.time() + DEADLINE_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(5.0,
                                                 deadline - time.time()))
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError("multi-process worker timed out")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()

    results = {}
    for out in outs:
        m = re.search(r"MHRESULT pid=(\d+) init=(\d+) kf=(\d+) "
                      r"lost=(\d+) phase=(-?\d+) n=(\d+) mesh=(\S+) "
                      r"ate_pct=(\S+) digest=(\S+)", out)
        assert m, f"no MHRESULT line in:\n{out[-2000:]}"
        results[int(m.group(1))] = m.groups()[1:]

    assert set(results) == {0, 1}
    for pid, (init, kf, lost, _phase, n, mesh, ate_pct, _digest) \
            in results.items():
        assert init == "1", f"rank {pid} failed to initialize"
        assert mesh == "2x2", f"rank {pid} mesh {mesh}"
        assert int(kf) >= 6, f"rank {pid} made only {kf} keyframes"
        assert lost == "0", f"rank {pid} lost {lost} frames"
        assert int(n) >= 30
        assert float(ate_pct) < 5.0, f"rank {pid} ATE {ate_pct}% of path"
    # Lockstep: the same host pipeline on the same collectives.
    assert results[0] == results[1], (results[0], results[1])


def worker(pid: int, port: int) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    os.environ["DMVIO_COORDINATOR"] = f"localhost:{port}"
    os.environ["DMVIO_NUM_PROCESSES"] = "2"
    os.environ["DMVIO_PROCESS_ID"] = str(pid)

    from dmvio_tpu_torch.models import full_system, imu_system, window
    from dmvio_tpu_torch.parallel import dist_init
    from dmvio_tpu_torch.utils import synthetic
    from dmvio_tpu_torch.utils import trajectory as tj

    assert dist_init.maybe_initialize(device="cpu")
    assert dist_init.maybe_initialize(device="cpu")      # idempotent
    assert dist_init.is_multiprocess()
    H, W = 128, 160
    n_frames = 36
    seq = synthetic.generate_vio_sequence(
        n_frames=n_frames, frame_dt=0.05, h=H, w=W,
        s_dso=1.4, g2=(0.06, -0.04), accel_scale=0.8, rot_scale=0.45,
        seed=3, scene=synthetic.default_scene(2.0, device="cpu"))
    cfg = window.Config(f_max=6, p_max=256, i_max=256, max_frames=4,
                        levels=4, ba_iters=4, mesh_devices=4)
    fs = full_system.FullSystem(seq["calib"], H, W, cfg, device="cpu",
                                imu_calib=imu_system.IMUCalib())
    assert fs.placer is not None and fs.placer.world == 2
    mesh = "x".join(str(d) for d in fs.placer.mesh.devices.shape)
    spf = seq["steps_per_frame"]
    for i in range(n_frames):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
    fs.finish()

    traj = fs.trajectory()
    pos = np.stack([t for (_ts, _R, t) in traj])
    digest = float(np.abs(pos).sum())
    gt = [(float(seq["timestamps"][i]), np.asarray(seq["R_body"][i]),
           seq["p_gt"][i]) for i in range(n_frames)]
    first_kf = min(fs.kf_poses.keys())
    est_t = [e for e, sh in zip(traj, fs.shells)
             if sh.frame_id >= first_kf + 5]
    gt_t = [g for g, sh in zip(gt, fs.shells)
            if sh.frame_id >= first_kf + 5]
    dist = float(np.sum(np.linalg.norm(
        np.diff(np.stack([g[2] for g in gt_t]), axis=0), axis=1)))
    ate_pct = 100 * tj.ate_rmse(est_t, gt_t, with_scale=True) / dist
    print(f"MHRESULT pid={pid} init={int(fs.initialized)} "
          f"kf={fs.stats_kf} lost={fs.stats_lost_frames} "
          f"phase={fs.imu.phase} n={len(traj)} mesh={mesh} "
          f"ate_pct={ate_pct:.4f} digest={digest:.9e}", flush=True)
    dist_init.shutdown()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]))
