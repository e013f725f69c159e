"""Parity of the port's BA stack (linearize, accumulate, solve_levenberg,
optimize, marg_fused) with dmvio_tpu, from a REAL window state.

The module fixture runs dmvio_tpu's FullSystem over the first 16 frames of
the tests/test_full_system.py fixture, fetches its window (frames, points,
pair_mask, images, the host float64 prior) and converts it with
dmvio_tpu_torch.convert, so both implementations start from identical
state. Each stage is fed the SAME inputs on both sides (the reference's
linearization converted for `accumulate`, its system for the solve), so the
tolerances below are per stage and do not compound:

* linearize: discrete masks (active, oob) equal; every float field to 1e-5
  of its largest magnitude (float32 projections in another operation order).
* accumulate: H and H_fd to 1e-5 of their largest entry (sums over ~1k
  pairs x 8 pixels in another order); b, a signed sum that cancels to a
  fraction of its terms, to 1e-4 of its largest entry, and so is b_d;
  H_dd to 1e-5 of its largest entry.
* solve_levenberg: steps to 1e-3 of their largest entry (a Jacobi-scaled
  f32 solve of a system whose diagonal spans 1e-2..1e10).
* optimize (up to 6 LM iterations, each an accept/reject on f32 energies):
  same iteration count, poses to 1e-4, idepths to 1e-3 relative, outlier
  masks equal, photometric energy to 1e-3 relative.
* marg_fused: victim list and masks equal, the prior increment to 1e-4 of
  its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import ba as jba
from dmvio_tpu.models import full_system as jfs
from dmvio_tpu.models import window as jwin
from dmvio_tpu.ops import ba_solve as jbs
from dmvio_tpu.ops import residuals as jres
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import ba as tba
from dmvio_tpu_torch.ops import ba_solve as tbs
from dmvio_tpu_torch.ops import residuals as tres
from test_full_system import H, W, make_sequence

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def near(got, ref, rel):
    """|got - ref| <= rel * max|ref| elementwise."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def window_pair():
    calib, images, _, _ = make_sequence(16)
    cfg = jwin.Config(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
                      ba_iters=6)
    fs = jfs.FullSystem(calib, H, W, cfg)
    for i, img in enumerate(images):
        fs.add_frame(img, timestamp=i * 0.05)
    assert fs.initialized and fs.stats_kf >= 4
    w = fs.win
    host = jax.device_get(dict(
        frames=w.frames, points=w.points, pair_mask=w.pair_mask,
        calib=w.calib, calib0=w.calib0, images=w.images, HM=w.HM,
        bM0=w.bM0, prior_diag=w.prior_diag))
    jprob = jba.BAProblem(
        frames=w.frames, points=w.points, calib=w.calib, calib0=w.calib0,
        HM=jnp.asarray(w.HM, jnp.float32), bM0=jnp.asarray(w.bM0, jnp.float32),
        prior_diag=jnp.asarray(w.prior_diag), pair_mask=w.pair_mask)
    s = convert.window_state(host, CPU)
    tprob = tba.BAProblem(
        frames=s["frames"], points=s["points"], calib=s["calib"],
        calib0=s["calib0"], HM=convert.tensor(s["HM"], CPU),
        bM0=convert.tensor(s["bM0"], CPU),
        prior_diag=convert.tensor(s["prior_diag"], CPU),
        pair_mask=s["pair_mask"])
    return fs, jprob, w.images, tprob, s["images"]


def test_window_state_is_real(window_pair):
    """The fixture window holds several keyframes, hundreds of points and a
    non-trivial marginalization prior."""
    fs, jprob, _, tprob, _ = window_pair
    assert int(tprob.frames.mask.sum()) >= 3
    assert int(tprob.points.mask.sum()) > 100
    assert int(tprob.pair_mask.sum()) > 300
    assert np.abs(fs.win.HM).max() > 0


def test_linearize(window_pair):
    _, jprob, jimg, tprob, timg = window_pair
    jl = jres.linearize(jprob.frames, jprob.points, jprob.calib, jimg,
                        jprob.pair_mask)
    tl = tres.linearize(tprob.frames, tprob.points, tprob.calib, timg,
                        tprob.pair_mask)
    assert int(np.asarray(jl.active).sum()) > 1000
    for name in jres.BAResiduals._fields:
        a = np.asarray(getattr(jl, name))
        b = getattr(tl, name)
        if a.dtype == bool:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        else:
            near(b, a, 1e-5)


def _residuals_from(jl):
    return tres.BAResiduals(*(convert.tensor(np.asarray(x), CPU)
                              for x in jl))


def test_accumulate(window_pair):
    _, jprob, jimg, tprob, _ = window_pair
    F = jprob.frames.mask.shape[0]
    jl = jres.linearize(jprob.frames, jprob.points, jprob.calib, jimg,
                        jprob.pair_mask)
    js = jbs.accumulate(jl, jprob.points.host, F)
    ts = tbs.accumulate(_residuals_from(jl), tprob.points.host, F)
    for name in ("H", "H_fd", "H_dd"):
        near(getattr(ts, name), getattr(js, name), 1e-5)
    near(ts.b, js.b, 1e-4)
    near(ts.b_d, js.b_d, 1e-4)
    assert float(ts.energy) == pytest.approx(float(js.energy), rel=1e-5)
    assert float(ts.num_terms) == float(js.num_terms)


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_solve_levenberg(window_pair, lam):
    _, jprob, jimg, tprob, _ = window_pair
    F = jprob.frames.mask.shape[0]
    jl = jres.linearize(jprob.frames, jprob.points, jprob.calib, jimg,
                        jprob.pair_mask)
    js = jbs.accumulate(jl, jprob.points.host, F)
    delta = jbs.state_delta(jprob.frames, jprob.calib, jprob.calib0)
    bM_eff = jprob.bM0 + jprob.HM @ delta
    b_prior = jprob.prior_diag * delta
    dx, dxd = jbs.solve_levenberg(js, jprob.HM, bM_eff, jprob.prior_diag,
                                  b_prior, jnp.asarray(lam, jnp.float32),
                                  jprob.frames.mask, jprob.points.mask)
    ts = tbs.BASystem(*(convert.tensor(np.asarray(x), CPU) for x in js))
    T = lambda x: convert.tensor(np.asarray(x), CPU)  # noqa: E731
    tdelta = tbs.state_delta(tprob.frames, tprob.calib, tprob.calib0)
    near(tdelta, delta, 1e-5)
    tdx, tdxd = tbs.solve_levenberg(
        ts, tprob.HM, T(bM_eff), tprob.prior_diag, T(b_prior),
        torch.tensor(lam), tprob.frames.mask, tprob.points.mask)
    near(tdx, dx, 1e-3)
    near(tdxd, dxd, 1e-3)


def test_optimize(window_pair):
    _, jprob, jimg, tprob, timg = window_pair
    jr = jba.optimize_jit(jprob, jimg, max_iters=6)
    tr = tba.optimize(tprob, timg, max_iters=6)
    assert int(tr.iters) == int(jr.iters)
    np.testing.assert_allclose(tr.frames.R_cw.numpy(),
                               np.asarray(jr.frames.R_cw), atol=1e-4)
    np.testing.assert_allclose(tr.frames.t_cw.numpy(),
                               np.asarray(jr.frames.t_cw), atol=1e-4)
    np.testing.assert_allclose(tr.frames.aff.numpy(),
                               np.asarray(jr.frames.aff), atol=1e-3)
    m = np.asarray(jprob.points.mask)
    np.testing.assert_allclose(tr.points.idepth.numpy()[m],
                               np.asarray(jr.points.idepth)[m], rtol=1e-3)
    np.testing.assert_array_equal(tr.pair_outlier.numpy(),
                                  np.asarray(jr.pair_outlier))
    assert float(tr.energy) == pytest.approx(float(jr.energy), rel=1e-3)
    np.testing.assert_allclose(tr.frame_th.numpy(), np.asarray(jr.frame_th),
                               rtol=1e-3)


def test_marg_fused(window_pair):
    fs, jprob, jimg, tprob, timg = window_pair
    slots = fs.win.slots_by_age()
    F = jprob.frames.mask.shape[0]
    age_rank = np.full(F, -1, np.int32)
    for r_, s_ in enumerate(slots):
        age_rank[s_] = r_
    newest = slots[-1]
    jo = jba.marg_fused_jit(jprob, jimg, jnp.asarray(age_rank),
                            jnp.asarray(1, jnp.int32), newest)
    to = tba.marg_fused(tprob, timg, torch.as_tensor(age_rank), 1, newest)
    vl, HM, bM, pts, pm, n_pre, n_post = jo
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(vl))
    assert int(np.asarray(vl)[0]) >= 0
    near(to[1], HM, 1e-4)
    near(to[2], bM, 1e-4)
    np.testing.assert_array_equal(to[3].mask.numpy(), np.asarray(pts.mask))
    np.testing.assert_array_equal(to[4].numpy(), np.asarray(pm))
    assert float(to[5]) == float(n_pre) and float(to[6]) == float(n_post)


@pytest.mark.parametrize("slot", [0, 2])
def test_marginalize_frame_prior(slot):
    """One frame's 8 coords Schur'd out of a random SPD prior: the device
    f32 form to 1e-4 of the largest entry (an f32 solve of a system with
    condition ~1e3), the host f64 form to 1e-9."""
    from dmvio_tpu.models import vio_ba as jvio

    rng = np.random.default_rng(2 + slot)
    F = 3
    C = jbs.cdim(F)
    A = rng.normal(size=(C + 5, C))
    HM = A.T @ A
    bM = rng.normal(size=C)
    jH, jb = jbs.marginalize_frame_prior(jnp.asarray(HM, jnp.float32),
                                         jnp.asarray(bM, jnp.float32), slot, F)
    tH, tb = tbs.marginalize_frame_prior(torch.tensor(HM, dtype=torch.float32),
                                         torch.tensor(bM, dtype=torch.float32),
                                         slot, F)
    near(tH, jH, 1e-4)
    near(tb, jb, 1e-4)
    marg = np.zeros(C, bool)
    marg[jbs.CPART + 8 * slot:jbs.CPART + 8 * slot + 8] = True
    jH64, jb64 = jvio.schur_out_np(HM, bM, marg)
    tH64, tb64 = tbs.schur_out_np(HM, bM, marg)
    np.testing.assert_allclose(tH64, jH64, rtol=0,
                               atol=1e-9 * np.abs(jH64).max())
    np.testing.assert_allclose(tb64, jb64, rtol=0,
                               atol=1e-9 * np.abs(jb64).max())
