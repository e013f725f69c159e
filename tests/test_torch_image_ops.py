"""Parity of the port's image ops (pyramid, bilinear sampling, point
selection, the saturating int cast) with dmvio_tpu on identical inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.ops import interp as jinterp
from dmvio_tpu.ops import pyramid as jpyr
from dmvio_tpu.ops import select as jsel
from dmvio_tpu.utils import camera as jcam
from dmvio_tpu.utils import synthetic as jsyn
from dmvio_tpu_torch.ops import interp as tinterp
from dmvio_tpu_torch.ops import pyramid as tpyr
from dmvio_tpu_torch.ops import select as tsel
from dmvio_tpu_torch.ops._cast import to_int32

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

H, W = 96, 128


def t(a, dtype=np.float32):
    return torch.as_tensor(np.array(a, dtype))


def scene_image():
    calib = jcam.Calib.create(100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5)
    R, tt = jnp.eye(3), jnp.zeros(3)
    return np.asarray(jsyn.render(jsyn.default_scene(2.0), R, tt, calib,
                                  H, W))


def test_saturating_int32_cast_matches_xla():
    x = np.array([1e10, -1e10, np.nan, np.inf, -np.inf, 3.7, -3.7, 2.0 ** 31,
                  -2.0 ** 31, 2147483520.0, 0.0], np.float32)
    ref = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    got = to_int32(torch.floor(t(x))).numpy()
    np.testing.assert_array_equal(got, ref)
    ref_trunc = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(to_int32(t(x)).numpy(), ref_trunc)


def test_build_pyramid():
    """2x2 means and central differences: equal to 1e-4 on 0-255 images
    (the mean's summation order may differ by an ulp)."""
    img = scene_image()
    jp = jpyr.build_pyramid(jnp.asarray(img), levels=4)
    tp = tpyr.build_pyramid(t(img), levels=4)
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("which", ["gather", "mxu"])
def test_bilinear_matches_both_reference_forms(which):
    """The port's one gather-bilinear equals the reference's gather form
    and its one-hot-matmul form (run at HIGHEST precision) to 1e-3 on a
    0-255 image, including clamped out-of-bounds and NaN coordinates."""
    rng = np.random.default_rng(0)
    img = scene_image()
    pyr = jpyr.build_pyramid(jnp.asarray(img), levels=1)[0]
    x = rng.uniform(-5, W + 5, (40, 8)).astype(np.float32)
    y = rng.uniform(-5, H + 5, (40, 8)).astype(np.float32)
    x[0, 0] = np.nan
    if which == "gather":
        r1 = jinterp.bilinear(pyr[0], jnp.asarray(x), jnp.asarray(y))
        r3 = jinterp.bilinear_stack(pyr, jnp.asarray(x), jnp.asarray(y))
    else:
        hi = jax.lax.Precision.HIGHEST
        r1 = jinterp.bilinear_mxu(pyr[0], jnp.asarray(x), jnp.asarray(y), hi)
        r3 = jinterp.bilinear_mxu_stack(pyr, jnp.asarray(x), jnp.asarray(y),
                                        hi)
    tp = t(np.asarray(pyr))
    g1 = tinterp.bilinear(tp[0], t(x), t(y)).numpy()
    g3 = tinterp.bilinear_stack(tp, t(x), t(y)).numpy()
    np.testing.assert_allclose(g1, np.asarray(r1), rtol=0, atol=1e-3)
    np.testing.assert_allclose(g3, np.asarray(r3), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(
        tinterp.in_bounds(t(x), t(y), H, W, 2.0).numpy(),
        np.asarray(jinterp.in_bounds(jnp.asarray(x), jnp.asarray(y), H, W,
                                     2.0)))
    np.testing.assert_array_equal(
        tinterp.nearest(tp[0], t(x), t(y)).numpy(),
        np.asarray(jinterp.nearest(pyr[0], jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("k", [128, 512])
def test_select_points_identical(k):
    """Selection is discrete: identical pixels, order and masks (the top-k
    tie-break is the lower flat index in both)."""
    img = scene_image()
    lvl = jpyr.build_pyramid(jnp.asarray(img), levels=1)[0]
    js = jsel.select_points(lvl, k, pot=4)
    ts = tsel.select_points(t(np.asarray(lvl)), k, pot=4)
    np.testing.assert_array_equal(ts.u.numpy(), np.asarray(js.u))
    np.testing.assert_array_equal(ts.v.numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_allclose(ts.score.numpy(), np.asarray(js.score),
                               rtol=1e-5)


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_occupancy_spacing(radius):
    rng = np.random.default_rng(radius)
    ue = rng.uniform(-10, W + 10, 60).astype(np.float32)
    ve = rng.uniform(-10, H + 10, 60).astype(np.float32)
    ue[0] = np.nan
    me = rng.uniform(size=60) > 0.3
    uc = rng.uniform(0, W, 80).astype(np.float32)
    vc = rng.uniform(0, H, 80).astype(np.float32)
    ref = jsel.occupancy_spacing(jnp.asarray(ue), jnp.asarray(ve),
                                 jnp.asarray(me), jnp.asarray(uc),
                                 jnp.asarray(vc), H, W, radius=radius, cell=8)
    got = tsel.occupancy_spacing(t(ue), t(ve), torch.as_tensor(me), t(uc),
                                 t(vc), H, W, radius=radius, cell=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_median_matches_numpy():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 64)).astype(np.float32)
    np.testing.assert_array_equal(tsel.median(t(x), dim=-1).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), -1)))
