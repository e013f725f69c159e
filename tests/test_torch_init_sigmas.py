"""The tracker-sigma init weighting and DMVIO_MATMUL_PRECISION in the port,
against dmvio_tpu.

* `_tracker_pose_sigmas` (host float64 in both packages) equals the
  reference's exactly on seeded SPD, singular and non-finite Hessians.
* With use_sig on, the coarse init's stacked residual and Jacobian and its
  LM solve match the reference's on the seeded init window of
  tests/test_imu_init.py (`build_case`) with seeded per-pose sigmas, at
  the tolerances of tests/test_torch_imu_init.py: residual and Jacobian to
  1e-4 of their largest entry; scale, gravity and bias to 1e-3,
  velocities to 1e-2 m/s, the scale marginal variance to 2% relative.
* Through IMUSystem.record_init_pose / try_initialize: with
  DMVIO_INIT_SIGMAS unset every recorded sigma is (0, 0) and the init is
  bit for bit the unweighted one; with it set to 1 the recorded sigmas are
  the tracker's and the weighted init runs.
* DMVIO_MATMUL_PRECISION sets torch's float32 matmul precision and the TF32
  flags when the port is imported; another value raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import imu_init as jii
from dmvio_tpu.models import imu_system as jis
from dmvio_tpu_torch.models import imu_init as tii
from dmvio_tpu_torch.models import imu_system as tis
from dmvio_tpu_torch.ops import preint as tpre
from test_imu_init import IMU_HZ, N_POSES, POSE_DT, build_case
from test_torch_imu_init import start, to_port
from test_vio_ba import G2_GT, S_GT, simulate_metric

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def spd_hessian(rng, scale):
    a = rng.normal(size=(8, 8))
    return (a @ a.T + 8.0 * np.eye(8)) * scale


def hessians():
    rng = np.random.default_rng(11)
    nan = spd_hessian(rng, 1e4)
    nan[2, 5] = np.nan
    inf = spd_hessian(rng, 1e4)
    inf[0, 0] = np.inf
    return {
        "spd": spd_hessian(rng, 1e4),
        "spd_tight": spd_hessian(rng, 1e7),
        "spd_clipped": spd_hessian(rng, 1e-1),
        "psd_rank3": np.diag([1e5, 1e5, 1e5, 0, 0, 0, 0, 0]),
        "singular": -1e-6 * np.eye(8),
        "nan": nan,
        "inf": inf,
    }


@pytest.mark.parametrize("name", sorted(hessians()))
def test_tracker_pose_sigmas_match_reference(name):
    H = hessians()[name]
    got = tis.IMUSystem._tracker_pose_sigmas(H)
    want = jis.IMUSystem._tracker_pose_sigmas(H)
    assert got == want
    assert all(0.0 <= s <= 0.1 for s in got)
    if name in ("singular", "nan", "spd_clipped"):
        assert got == (0.1, 0.1)


def seeded_sigmas(seed=5):
    rng = np.random.default_rng(seed)
    N = jii.N_MAX
    sig_rot = np.zeros(N, np.float32)
    sig_pos = np.zeros(N, np.float32)
    sig_rot[:N_POSES] = rng.uniform(5e-4, 5e-3, N_POSES)
    sig_pos[:N_POSES] = rng.uniform(1e-3, 2e-2, N_POSES)
    return sig_rot, sig_pos


@pytest.fixture(scope="module")
def sig_case():
    st, v_gt = build_case()
    sig_rot, sig_pos = seeded_sigmas()
    st = st._replace(sig_rot=jnp.asarray(sig_rot),
                     sig_pos=jnp.asarray(sig_pos))
    pst = to_port(st)._replace(sig_rot=torch.as_tensor(sig_rot),
                               sig_pos=torch.as_tensor(sig_pos))
    return st, pst, v_gt


def test_weighted_residual_and_jacobian_match_reference(sig_case):
    st, pst, _ = sig_case
    N = jii.N_MAX
    rng = np.random.default_rng(4)
    x = np.concatenate([[np.log(S_GT) + 0.1], G2_GT + 0.02,
                        rng.normal(0, 0.01, 6),
                        rng.normal(0, 0.3, 3 * N)]).astype(np.float32)
    r_j = np.asarray(jii._residual_all(jnp.asarray(x), st, jnp.eye(3),
                                       jnp.zeros(3), N, use_sig=True))
    J_j = np.asarray(jax.jacfwd(lambda y: jii._residual_all(
        y, st, jnp.eye(3), jnp.zeros(3), N, use_sig=True))(jnp.asarray(x)))
    r_t, J_t = tii._linearize(torch.as_tensor(x), pst, torch.eye(3),
                              torch.zeros(3), True, use_sig=True)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0,
                               atol=1e-4 * np.abs(r_j).max())
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=0,
                               atol=1e-4 * np.abs(J_j).max())
    # The weighting acts: the unweighted residual is another.
    r_0, _ = tii._linearize(torch.as_tensor(x), pst, torch.eye(3),
                            torch.zeros(3), False)
    assert np.abs(r_0.numpy() - r_t.numpy()).max() > 1e-2 * np.abs(r_j).max()


def test_weighted_optimize_matches_reference(sig_case):
    st, pst, _ = sig_case
    x0 = start()
    jres = jii.optimize_jit(st, jnp.eye(3), jnp.zeros(3), use_sig=True,
                            **{k: jnp.asarray(v, jnp.float32)
                               for k, v in x0.items()})
    tres = tii.optimize(pst, torch.eye(3), torch.zeros(3), use_sig=True,
                        **{k: torch.as_tensor(np.asarray(v, np.float32))
                           for k, v in x0.items()})
    assert bool(tres.ok) and bool(jres.ok)
    assert float(tres.s_log) == pytest.approx(float(jres.s_log), abs=1e-3)
    np.testing.assert_allclose(tres.g2.numpy(), np.asarray(jres.g2),
                               atol=1e-3)
    np.testing.assert_allclose(tres.bias.numpy(), np.asarray(jres.bias),
                               atol=1e-3)
    np.testing.assert_allclose(tres.v.numpy()[:N_POSES],
                               np.asarray(jres.v)[:N_POSES], atol=1e-2)
    assert float(tres.s_var) == pytest.approx(float(jres.s_var), rel=0.02)


def fill_window(imu):
    """Record build_case's window through record_init_pose: each pose is
    its own keyframe (so it resolves to the exact pose), its chunk the
    host preintegration of the samples since the previous pose, its
    tracker Hessian a seeded SPD matrix. Returns (kf_poses, Hessians)."""
    st, _ = build_case()
    dt = 1.0 / IMU_HZ
    spp = int(POSE_DT * IMU_HZ)
    accs, gyrs, _ = simulate_metric(spp * (N_POSES - 1), dt, noise=True,
                                    seed=2)
    rng = np.random.default_rng(9)
    Rs, ts = np.asarray(st.R_cw), np.asarray(st.t_cw)
    kf_poses, Hs = {}, []
    for k in range(N_POSES):
        if k == 0:
            pre_np = tis._identity_np()
        else:
            s0, s1 = (k - 1) * spp, k * spp
            pre_np = tpre.preintegrate_np(accs[s0:s1], gyrs[s0:s1],
                                          np.full(s1 - s0, dt), np.zeros(6))
        Hs.append(spd_hessian(rng, 1e5))
        imu.record_init_pose(
            k, k, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            Rs[k], chunk=dict(pre_np=pre_np,
                              acc_mean=np.array([0.0, 0.0, 9.81])),
            H_vis=Hs[-1])
        kf_poses[k] = (Rs[k], ts[k])
    return kf_poses, Hs


def run_init(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("DMVIO_INIT_SIGMAS", raising=False)
    else:
        monkeypatch.setenv("DMVIO_INIT_SIGMAS", env)
    imu = tis.IMUSystem(tis.IMUCalib(), 8, torch.device("cpu"))
    kf_poses, Hs = fill_window(imu)
    calls = []
    optimize = tii.optimize

    def spy(st, *a, **k):
        calls.append((st, a, k))
        return optimize(st, *a, **k)

    monkeypatch.setattr(tii, "optimize", spy)
    imu.try_initialize(kf_poses)
    assert len(calls) == 1
    return imu, Hs, calls[0]


def test_init_unweighted_when_variable_unset(monkeypatch):
    imu, _, (st, a, k) = run_init(monkeypatch, None)
    assert imu._init_sigs == [(0.0, 0.0)] * N_POSES
    assert k["use_sig"] is False
    # The same call without the sigma fields (the state the init built
    # before the weighting was ported) gives the same result bit for bit.
    plain = {kk: v for kk, v in k.items() if kk != "use_sig"}
    want = tii.optimize(st._replace(sig_rot=None, sig_pos=None), *a, **plain)
    for f in tii.CoarseInitResult._fields:
        assert np.array_equal(np.asarray(getattr(imu.init_result, f)),
                              getattr(want, f).numpy()), f


def test_init_weighted_when_variable_set(monkeypatch):
    imu, Hs, (st, a, k) = run_init(monkeypatch, "1")
    want = [tis.IMUSystem._tracker_pose_sigmas(H) for H in Hs]
    assert imu._init_sigs == want
    assert k["use_sig"] is True
    np.testing.assert_array_equal(
        st.sig_rot.numpy()[:N_POSES], np.float32([s[0] for s in want]))
    np.testing.assert_array_equal(
        st.sig_pos.numpy()[:N_POSES], np.float32([s[1] for s in want]))
    assert not st.sig_rot[N_POSES:].any()
    plain = {kk: v for kk, v in k.items() if kk != "use_sig"}
    unweighted = tii.optimize(st, *a, **plain)
    assert not np.array_equal(np.asarray(imu.init_result.v),
                              unweighted.v.numpy())


_PRECISION = """
import torch, dmvio_tpu_torch
print(torch.get_float32_matmul_precision(),
      torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
"""


def import_port(value):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("DMVIO_MATMUL_PRECISION", None)
    if value is not None:
        env["DMVIO_MATMUL_PRECISION"] = value
    return subprocess.run([sys.executable, "-c", _PRECISION], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("value,want", [
    (None, "highest False False"),
    ("highest", "highest False False"),
    ("high", "high True True"),
    ("default", "medium True True"),
])
def test_matmul_precision_variable(value, want):
    out = import_port(value)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == want


@pytest.mark.parametrize("value", ["medium", "fastest", ""])
def test_matmul_precision_bad_value_raises(value):
    out = import_port(value)
    assert out.returncode != 0
    assert "DMVIO_MATMUL_PRECISION" in out.stderr
    assert "highest, high, default" in out.stderr
