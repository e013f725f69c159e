"""Parity of the port's substrate (camera, lie, trajectory, synthetic) with
dmvio_tpu on identical numpy inputs.

Tolerances: float32 elementwise maths in both frameworks differs only in
rounding (a few ulps), so values are held to rtol/atol 1e-5 unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.utils import camera as jcam
from dmvio_tpu.utils import lie as jlie
from dmvio_tpu.utils import synthetic as jsyn
from dmvio_tpu.utils import trajectory as jtraj
from dmvio_tpu_torch.utils import camera as tcam
from dmvio_tpu_torch.utils import lie as tlie
from dmvio_tpu_torch.utils import synthetic as tsyn
from dmvio_tpu_torch.utils import trajectory as ttraj

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(kw or TOL))


def test_camera_levels_and_projection():
    rng = np.random.default_rng(0)
    jc = jcam.Calib.create(380.0, 372.5, 255.5, 251.0)
    tc = tcam.Calib.create(380.0, 372.5, 255.5, 251.0, device="cpu")
    for lvl in range(6):
        close(jc.at_level(lvl).as_vec(), tc.at_level(lvl).as_vec())
    close(jc.K(), tc.K())
    p = rng.normal(0, 1, (50, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    close(jcam.project(jc, jnp.asarray(p)), tcam.project(tc, t(p)), rtol=1e-5,
          atol=1e-3)
    uv = rng.uniform(0, 500, (50, 2)).astype(np.float32)
    d = rng.uniform(0.2, 3.0, 50).astype(np.float32)
    close(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(d)),
          tcam.backproject(tc, t(uv), t(d)))
    assert tcam.level_shapes(96, 128, 4) == jcam.level_shapes(96, 128, 4)
    np.testing.assert_array_equal(tcam.PATTERN, jcam.PATTERN)


@pytest.mark.parametrize("scale", [1e-6, 0.3, 2.0])
def test_lie_exp_log_adj(scale):
    rng = np.random.default_rng(1)
    xi = (rng.normal(0, 1, (64, 6)) * scale).astype(np.float32)
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    tR, tt = tlie.se3_exp(t(xi))
    close(jR, tR)
    close(jt, tt)
    close(jlie.se3_log(jR, jt), tlie.se3_log(t(jR), t(jt)), rtol=1e-4,
          atol=2e-5)
    close(jlie.se3_adj(jR, jt), tlie.se3_adj(t(jR), t(jt)))
    close(jlie.quat_from_rot(jR), tlie.quat_from_rot(t(jR)))
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    close(jlie.rot_from_quat(jnp.asarray(q)), tlie.rot_from_quat(t(q)))
    R2, t2 = jlie.se3_retract(jR, jt, jnp.asarray(xi[::-1].copy()))
    R2t, t2t = tlie.se3_retract(t(jR), t(jt), t(xi[::-1].copy()))
    close(R2, R2t)
    close(t2, t2t)


def test_lie_log_near_pi():
    """The axis recovery near t = pi (as in test_lie.py)."""
    rng = np.random.default_rng(2)
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    for ang in (np.pi - 1e-3, np.pi - 1e-5, 3.0):
        w = (axes * ang).astype(np.float32)
        jR = jlie.so3_exp(jnp.asarray(w))
        jw = np.asarray(jlie.so3_log(jR))
        tw = tlie.so3_log(t(jR)).numpy()
        # Near pi the log is conditioned by sqrt(eps): 1e-3 rad.
        np.testing.assert_allclose(tw, jw, atol=1e-3)
        # Round trip: the angle near pi is recovered to sqrt(eps) ~ 3e-4.
        back = tlie.so3_exp(torch.as_tensor(tw)).numpy()
        np.testing.assert_allclose(back, np.asarray(jR), atol=1e-3)


def test_trajectory_ate_and_tum(tmp_path):
    rng = np.random.default_rng(3)
    n = 20
    R = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(0, 0.3, (n, 3)).astype(np.float32))))
    p = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    gt = [(i * 0.1, R[i], p[i]) for i in range(n)]
    est = [(i * 0.1, R[i], 2.0 * p[i] + rng.normal(0, 0.01, 3) + 1.0)
           for i in range(n)]
    for ws in (True, False):
        assert ttraj.ate_rmse(est, gt, ws) == pytest.approx(
            jtraj.ate_rmse(est, gt, ws), rel=1e-12)
    path = tmp_path / "tum.txt"
    ttraj.write_tum(str(path), est)
    back = jtraj.read_tum(str(path))
    back_t = ttraj.read_tum(str(path))
    for a, b in zip(back, back_t):
        np.testing.assert_allclose(a[1], b[1], atol=1e-6)
        np.testing.assert_allclose(a[2], b[2], atol=0)
    assert ttraj.path_length(p) == pytest.approx(
        float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum()))


def test_synthetic_render_and_depth():
    """Rendered images agree to 1e-3 intensity units on a 0-255 image (the
    texture sums ~15 float32 sines of arguments up to ~100 rad)."""
    H, W = 48, 64
    jc = jcam.Calib.create(60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)
    tc = tcam.Calib.create(60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5,
                           device="cpu")
    js = jsyn.default_scene(2.0)
    ts = tsyn.default_scene(2.0, device="cpu")
    for a, b in zip(js, ts):
        close(a, b)
    xi = np.array([0.05, -0.02, 0.03, 0.02, -0.04, 0.01], np.float32)
    R, tt = jlie.se3_exp(jnp.asarray(xi))
    close(jsyn.render(js, R, tt, jc, H, W), tsyn.render(ts, t(R), t(tt), tc,
                                                      H, W),
          rtol=0, atol=1e-3)
    u = np.linspace(0, W - 1, 17).astype(np.float32)
    v = np.linspace(0, H - 1, 17).astype(np.float32)
    close(jsyn.gt_idepth(js, R, tt, jc, jnp.asarray(u), jnp.asarray(v)),
          tsyn.gt_idepth(ts, t(R), t(tt), tc, t(u), t(v)))
