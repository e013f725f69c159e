"""How far the tracked rotations drift from orthonormality, and where the
port's realtime run parts from the reference's.

Default: runs the port's realtime VIO (dmvio_tpu_torch, on the CPU) on the
seed-3 fixture of tests/test_torch_full_vio_rt.py (192x256, 48 frames,
async_fetch=False; with `--serial`, the serial VIO of
tests/test_torch_full_vio_seed3.py on the same fixture) and prints, per
frame, det(R_c_ref) - 1 of the tracked shell, and det(R_cw) - 1 of every
window keyframe at the end. With `--ref N` (realtime only) it also runs
the JAX reference's realtime run over the first N frames of the same
images and prints, per shell, the largest difference of R_c_ref and
t_c_ref between the two, and the reference's own determinants. One JSON
line each.

`--ops` holds the port's rotation ops to the reference's on identical
float32 inputs (20000 draws each) and prints, per op, the mean and rms of
the determinant's departure from 1 that the op adds: so3_exp at small
angles, a 3x3 product (single and batched), the left retraction, 40
chained retractions as one tracker level's LM takes them, and the realtime
constant-velocity candidate R_last R_prev^T R_last.

`--ladder N` runs both packages' realtime VIO (the CLI's preset=1 Config,
async_fetch=False) on the first N frames of the seed-7 dataset that
tests/test_torch_cli_vio_rt.py writes (the port's make_synthetic, seed 7,
into build/drift_seed7/) and prints, per tracked frame and package, the
candidates' det - 1, the ladder's energy gate, the winning candidate and
its finest-level energy, and the winner's det - 1.

    python tools/rotation_drift.py [--serial | --ref N | --ops | --ladder N]
"""

import json
import os
import sys

# The reference under the test suite's setup (tests/conftest.py): XLA on
# the CPU with 8 virtual devices, set before anything imports jax.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def det1(R) -> float:
    """det(R) - 1 in float64."""
    return float(np.linalg.det(np.asarray(R, np.float64)) - 1.0)


def dets(Rs) -> np.ndarray:
    return np.linalg.det(np.asarray(Rs, np.float64)) - 1.0


def ops():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from dmvio_tpu.utils import lie as jl
    from dmvio_tpu_torch.utils import lie as tl

    rng = np.random.default_rng(1)
    n = 20000

    def rots(k):
        return np.stack([tl.exp_so3_np(w) for w in rng.normal(size=(k, 3))]
                        ).astype(np.float32)

    def stat(x):
        return {"mean": float(np.mean(x)), "rms": float(np.sqrt(np.mean(
            np.square(x))))}

    out = {}
    for mag in (1e-3, 1e-2):
        w = (rng.normal(size=(n, 3)) * mag).astype(np.float32)
        out[f"so3_exp |w|~{mag}"] = {
            "jax": stat(dets(jl.so3_exp(jnp.asarray(w)))),
            "port": stat(dets(tl.so3_exp(torch.as_tensor(w))))}
    A, B = rots(n), rots(n)
    base = dets(A) + dets(B)
    pj = np.asarray(jnp.asarray(A) @ jnp.asarray(B))
    pt = (torch.as_tensor(A) @ torch.as_tensor(B)).numpy()
    single = np.stack([(torch.as_tensor(A[i]) @ torch.as_tensor(B[i])).numpy()
                       for i in range(2000)])
    out["3x3 product, batched"] = {"jax": stat(dets(pj) - base),
                                   "port": stat(dets(pt) - base)}
    out["3x3 product, single (port)"] = {
        "port": stat(dets(single) - base[:2000]),
        "equal_to_jax": float(np.mean(np.all(single == pj[:2000],
                                             axis=(1, 2))))}
    z = np.zeros((n, 3), np.float32)
    xi = (rng.normal(size=(n, 6)) * 1e-3).astype(np.float32)
    out["se3_retract |xi|~1e-3"] = {
        "jax": stat(dets(jl.se3_retract(jnp.asarray(A), jnp.asarray(z),
                                        jnp.asarray(xi))[0]) - dets(A)),
        "port": stat(dets(tl.se3_retract(torch.as_tensor(A),
                                         torch.as_tensor(z),
                                         torch.as_tensor(xi))[0])
                     - dets(A))}
    m = 2000
    Rj, Rt = jnp.asarray(A[:m]), torch.as_tensor(A[:m])
    for k in range(40):
        s = (rng.normal(size=(m, 6)) * 1e-3 * 0.9 ** k).astype(np.float32)
        Rj = jl.se3_retract(Rj, jnp.asarray(z[:m]), jnp.asarray(s))[0]
        Rt = tl.se3_retract(Rt, torch.as_tensor(z[:m]), torch.as_tensor(s))[0]
    out["40 chained retractions"] = {"jax": stat(dets(Rj) - dets(A[:m])),
                                     "port": stat(dets(Rt) - dets(A[:m]))}
    # Constant velocity from two poses whose det departs by ~1e-6.
    Rl = np.asarray(A[:m], np.float64) * (1 + 3e-7)
    Rp = np.asarray(B[:m], np.float64) * (1 + 3e-7)
    Rl, Rp = Rl.astype(np.float32), Rp.astype(np.float32)
    cj = np.asarray(jnp.asarray(Rl) @ jnp.swapaxes(jnp.asarray(Rp), 1, 2)
                    @ jnp.asarray(Rl))
    ct = (torch.as_tensor(Rl) @ torch.as_tensor(Rp).transpose(1, 2)
          @ torch.as_tensor(Rl)).numpy()
    growth = 2 * dets(Rl) + dets(Rp)
    out["R_last R_prev^T R_last minus (2 e_last + e_prev)"] = {
        "jax": stat(dets(cj) - growth), "port": stat(dets(ct) - growth),
        "e_in_rms": float(np.sqrt(np.mean(dets(Rl) ** 2)))}
    print(json.dumps(out))


def ladder(n):
    """Per tracked frame of both packages' realtime VIO: candidate dets,
    gate, winner, its energy and det."""
    data = os.path.join(ROOT, "build", "drift_seed7")
    from dmvio_tpu_torch.tools import make_synthetic

    if not os.path.exists(os.path.join(data, "meta.npz")):
        make_synthetic.main([f"out={data}", "seed=7", "device=cpu"])
    kw = dict(imu_file=data + "/imu.txt", ts_file=data + "/times.txt")
    cfg = dict(i_max=1536, p_max=2048, max_frames=7, ba_iters=6,
               realtime=True, async_fetch=False)
    for which in ("jax", "port"):
        rec = []
        if which == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            from dmvio_tpu.io import dataset as ds
            from dmvio_tpu.models import coarse_tracker, full_system
            from dmvio_tpu.models import imu_system, window
            rd = ds.open_dataset(data + "/images", data + "/camera.txt", **kw)
            orig = coarse_tracker.track_multi_jit
            fs = full_system.FullSystem(
                rd.undist.K_out, 256, 320, window.Config(**cfg),
                imu_calib=imu_system.IMUCalib())
            attr = "track_multi_jit"
        else:
            from dmvio_tpu_torch.io import dataset as ds
            from dmvio_tpu_torch.models import coarse_tracker, full_system
            from dmvio_tpu_torch.models import imu_system, window
            rd = ds.open_dataset(data + "/images", data + "/camera.txt",
                                 device="cpu", **kw)
            orig = coarse_tracker.track_multi
            fs = full_system.FullSystem(
                rd.undist.K_out, 256, 320, window.Config(**cfg), device="cpu",
                imu_calib=imu_system.IMUCalib())
            attr = "track_multi"

        def wrapped(ref, pyr, calib, R_c, t_c, mask_c, rho, b, gate, *a,
                    **k):
            res, packed = orig(ref, pyr, calib, R_c, t_c, mask_c, rho, b,
                               gate, *a, **k)
            pk = np.asarray(packed)
            rec.append({"cand_det": [float(f"{x:.3e}") for x in dets(
                np.asarray(R_c))], "gate": float(np.asarray(gate)),
                "sel": int(pk[-2]), "e0": float(pk[25]),
                "det": float(f"{det1(np.asarray(res.R)):.3e}")})
            return res, packed

        setattr(full_system.coarse_tracker, attr, wrapped)
        try:
            for i in range(n):
                acc, gyr, dts_ = rd.get_imu_chunk(i)
                k0 = len(rec)
                fs.add_frame(rd.get_image(i), rd.frames[i].timestamp,
                             imu_data=(acc, gyr, dts_) if len(dts_) else None,
                             exposure=rd.frames[i].exposure)
                for r in rec[k0:]:
                    print(json.dumps({"pkg": which, "frame": i,
                                      "ref_kf": fs.ref_kf_id, **r}),
                          flush=True)
        finally:
            setattr(full_system.coarse_tracker, attr, orig)


def main():
    args = sys.argv[1:]
    if "--ops" in args:
        ops()
        return
    if "--ladder" in args:
        ladder(int(args[args.index("--ladder") + 1]))
        return
    from test_torch_full_vio_rt import (CFG, H, N_FRAMES, SEQ, W,  # noqa
                                        imu_chunk, run_port_rt)
    from test_torch_full_vio_seed3 import run_port

    if "--serial" in args:
        port, _ = run_port(N_FRAMES)
    else:
        port, _ = run_port_rt(N_FRAMES, seed=SEQ["seed"])
    print(json.dumps({
        "shell_det": [det1(sh.R_c_ref) for sh in port.shells],
        "keyframe_det": {int(f): det1(v[0])
                         for f, v in sorted(port.kf_poses.items())}}))
    if "--ref" in args:
        n = int(args[args.index("--ref") + 1])
        import jax

        jax.config.update("jax_platforms", "cpu")
        from dmvio_tpu.models import full_system, imu_system, window
        from dmvio_tpu.utils import synthetic

        seq = synthetic.generate_vio_sequence(
            n_frames=n, scene=synthetic.default_scene(depth=2.0), **SEQ)
        ref = full_system.FullSystem(seq["calib"], H, W,
                                     window.Config(**CFG),
                                     imu_calib=imu_system.IMUCalib())
        for i in range(n):
            ref.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                          imu_data=imu_chunk(seq, i))
        ref.finish()
        diff = [{"frame": a.frame_id, "ref_kf": [a.ref_kf_id, b.ref_kf_id],
                 "R": float(np.abs(a.R_c_ref - np.asarray(b.R_c_ref)).max()),
                 "t": float(np.abs(a.t_c_ref - np.asarray(b.t_c_ref)).max())}
                for a, b in zip(port.shells[:n], ref.shells)]
        print(json.dumps({
            "ref_shell_det": [det1(sh.R_c_ref) for sh in ref.shells],
            "ref_keyframe_det": {int(f): det1(v[0])
                                 for f, v in sorted(ref.kf_poses.items())},
            "shell_diff": diff}))


if __name__ == "__main__":
    main()
