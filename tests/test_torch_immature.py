"""Parity of the port's immature-point trace and activation with dmvio_tpu.

The pool, poses and images of tests/test_immature.py go, as the same numpy
arrays, to the JAX functions (XLA on the CPU) and to the port
(device="cpu"). Each step starts both sides from the SAME pool (the
reference's output converted with dmvio_tpu_torch.convert), so differences
do not compound across steps.

Tolerances: status codes, masks and the activation verdict are discrete and
must be equal. The epipolar search picks the same discrete sample, then
three GN steps refine it in float32 with another summation order, so the
refined interval bounds agree to 1e-4 relative, or 1e-5 absolute for the
lower bounds that sit near their clip at 0. The activation GN runs
4 idepth steps through the pattern sampler (kernel K1's plain version):
idepth to 1e-4 relative, energy to 1e-3 relative (a sum of squared
residuals that cancel to a few grey levels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.ops import immature as jimm
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.ops import immature as timm
from test_immature import K, make_pool, setup_scene

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a):
    return convert.tensor(np.asarray(a), CPU)


@pytest.fixture(scope="module")
def scene():
    calib, scene, R, t_, images = setup_scene(4)
    pool, id_gt = make_pool(calib, scene, R, t_, images)
    return calib, R, t_, images, pool


def _trace_both(calib, R, t_, images, pool, f):
    Rh = jnp.broadcast_to(R[0], (K, 3, 3))
    th = jnp.broadcast_to(t_[0], (K, 3))
    affh = jnp.zeros((K, 2))
    aff = jnp.zeros((2,))
    ref = jimm.trace(pool, Rh, th, affh, R[f], t_[f], aff, images[f], calib)
    got = timm.trace(convert.immature_pool(pool, CPU), t(Rh), t(th), t(affh),
                     t(R[f]), t(t_[f]), t(aff), t(images[f]),
                     convert.calib(calib, CPU))
    return ref, got


def test_trace_elementwise(scene):
    """Three successive traces (frames 1-3), each from the reference's pool
    of the step before: status codes equal, interval bounds of GOOD points
    to 1e-4 relative, quality to 1e-3 relative."""
    calib, R, t_, images, pool = scene
    for f in range(1, 4):
        ref, got = _trace_both(calib, R, t_, images, pool, f)
        st = np.asarray(ref.status)
        np.testing.assert_array_equal(got.status.numpy(), st)
        good = st == jimm.IPS_GOOD
        assert good.sum() > K // 4, (f, good.sum())
        for name in ("idepth_min", "idepth_max"):
            np.testing.assert_allclose(
                getattr(got, name).numpy()[good],
                np.asarray(getattr(ref, name))[good], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.quality.numpy()[good],
                                   np.asarray(ref.quality)[good], rtol=1e-3)
        pool = ref


def test_activate_elementwise(scene):
    """Activation of the traced pool against all 4 frames: the verdict is
    equal, idepth to 1e-4 relative, energy to 1e-3 relative."""
    calib, R, t_, images, pool = scene
    for f in range(1, 4):
        pool, _ = _trace_both(calib, R, t_, images, pool, f)
    cand = np.asarray(pool.status) == jimm.IPS_GOOD
    frames_mask = np.ones(4, bool)
    aff = np.zeros((4, 2), np.float32)
    d, ok, energy = jimm.activate(pool, jnp.asarray(cand), R, t_,
                                  jnp.asarray(aff), jnp.asarray(frames_mask),
                                  images, calib)
    td, tok, tenergy = timm.activate(
        convert.immature_pool(pool, CPU), torch.as_tensor(cand), t(R), t(t_),
        t(aff), torch.as_tensor(frames_mask), t(images),
        convert.calib(calib, CPU))
    ok = np.asarray(ok)
    assert ok.sum() > K * 0.4
    np.testing.assert_array_equal(tok.numpy(), ok)
    np.testing.assert_allclose(td.numpy()[cand], np.asarray(d)[cand],
                               rtol=1e-4)
    np.testing.assert_allclose(tenergy.numpy()[ok], np.asarray(energy)[ok],
                               rtol=1e-3, atol=1e-3)
