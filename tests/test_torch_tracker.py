"""Parity of the port's initializer and coarse tracker with dmvio_tpu.

Same numpy inputs go to the JAX function (XLA on the CPU) and to the port
(device="cpu"). The LM loops accept/reject on float32 energies, so the two
paths agree to float32 rounding propagated through a few dozen GN steps;
the tolerances below are stated per quantity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import coarse_tracker as jct
from dmvio_tpu.models import initializer as jinit
from dmvio_tpu.ops import align as jalign
from dmvio_tpu.ops import init_gn as jgn
from dmvio_tpu.ops import pyramid as jpyr
from dmvio_tpu.ops import select as jsel
from dmvio_tpu.utils import camera as jcam
from dmvio_tpu.utils import lie as jlie
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import coarse_tracker as tct
from dmvio_tpu_torch.models import initializer as tinit
from dmvio_tpu_torch.ops import align as talign
from dmvio_tpu_torch.ops import init_gn as tgn
from dmvio_tpu_torch.utils import camera as tcam
from test_coarse_tracker import (H_IMG, LEVELS, W_IMG, make_ref,
                                 render_plane, synth_image)
from test_full_system import H, W, make_sequence

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a, dtype=None):
    a = np.array(a)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


def tpyr(pyr):
    return tuple(t(np.asarray(p)) for p in pyr)


@pytest.fixture(scope="module")
def vo_frames():
    calib, images, _, _ = make_sequence(8)
    jpyrs = [tuple(jpyr.build_pyramid(img, levels=4)) for img in images]
    return calib, jpyrs


def _init_level_inputs(calib, pyrs, sel, lvl):
    from dmvio_tpu.ops import interp as jinterp
    from dmvio_tpu.utils.camera import PATTERN

    s = 0.5 ** lvl
    ul = (sel.u + 0.5) * s - 0.5
    vl = (sel.v + 0.5) * s - 0.5
    ref = pyrs[0][lvl]
    h, w = ref.shape[-2:]
    m = sel.mask & jinterp.in_bounds(ul, vl, h, w, pad=2.0)
    pat = jnp.asarray(PATTERN)
    color = jinterp.bilinear(ref[0], ul[:, None] + pat[:, 0],
                             vl[:, None] + pat[:, 1])
    return calib.at_level(lvl), ul, vl, color, m


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_init_level_system(vo_frames, lvl):
    """The joint system of one init GN evaluation at a fixed state (no
    loop): H_pp/b_p to 1e-4 of their largest entry, per-point blocks to
    1e-4 relative, energy and term count to 1e-5 relative."""
    calib, pyrs = vo_frames
    sel = jsel.select_points(pyrs[0][0], 512, pot=4)
    cal_l, ul, vl, color, m = _init_level_inputs(calib, pyrs, sel, lvl)
    R, tt = jlie.se3_exp(jnp.array([0.04, -0.01, 0.02, 0.01, -0.02, 0.005]))
    d = jnp.asarray(np.random.default_rng(lvl).uniform(0.7, 1.3, 512),
                    jnp.float32)
    ref = jgn._level_system(pyrs[5][lvl], cal_l, ul, vl, color, m, R, tt,
                            jnp.asarray(0.05), jnp.asarray(-1.0), d)
    got = tgn._level_system(
        t(np.asarray(pyrs[5][lvl])), convert.calib(cal_l, CPU), t(ul), t(vl),
        t(color), t(m), t(R)[None], t(tt)[None], torch.tensor([0.05]),
        torch.tensor([-1.0]), t(d)[None])
    for a, b in zip(ref[:7], got):
        a = np.asarray(a)
        np.testing.assert_allclose(b[0].numpy(), a, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-6))


def test_init_coarsest_level_lm(vo_frames):
    """A whole LM solve of the coarsest level (10 accepted/rejected GN
    steps) from the same start: pose to 1e-5, idepth to 1e-3, same
    iteration count and final damping."""
    calib, pyrs = vo_frames
    sel = jsel.select_points(pyrs[0][0], 512, pot=4)
    cal_l, ul, vl, color, m = _init_level_inputs(calib, pyrs, sel, 3)
    st = jgn.run_level(pyrs[5][3], cal_l, ul, vl, color, m, jnp.eye(3),
                       jnp.asarray([0.05, 0.0, 0.0]), jnp.zeros(()),
                       jnp.zeros(()), jnp.ones(512), 10)
    stt = tgn.run_level(
        t(np.asarray(pyrs[5][3])), convert.calib(cal_l, CPU), t(ul), t(vl),
        t(color), t(m), torch.eye(3)[None], torch.tensor([[0.05, 0.0, 0.0]]),
        torch.zeros(1), torch.zeros(1), torch.ones(1, 512), 10)
    np.testing.assert_allclose(stt.R[0].numpy(), np.asarray(st.R), atol=1e-5)
    np.testing.assert_allclose(stt.t[0].numpy(), np.asarray(st.t), atol=1e-5)
    np.testing.assert_allclose(stt.idepth[0].numpy(), np.asarray(st.idepth),
                               atol=1e-3)
    assert int(stt.it[0]) == int(st.it)
    assert float(stt.lam[0]) == pytest.approx(float(st.lam), rel=1e-6)


def test_visual_initializer_handoff(vo_frames):
    """The 7-hypothesis initializer hands over on the same frame, with the
    same selected points and mask, and pose to 1e-3. The finer levels run
    up to 50 LM steps whose accept/reject decisions sit on float32 energy
    ties (a single flip moves weakly constrained depths by a few percent),
    so inverse depths are held statistically: median relative difference
    below 1e-3, 99% of points within 1e-2, all within 10%.

    Once snapped, the alpha prior is off and the photometric energy is
    invariant to scaling idepth and t together: the raw scale (median
    idepth before normalization) is a gauge that only the weak smoothing
    term moves, and it drifts along a different accept/reject path in each
    implementation (measured 1.085 against 1.023). The normalized t and
    idepth above are gauge-free; the raw scale is held to 10%."""
    calib, pyrs = vo_frames
    ji = jinit.VisualInitializer(calib, H, W, n_points=512, levels=4)
    ti = tinit.VisualInitializer(convert.calib(calib, CPU), H, W,
                                 n_points=512, levels=4)
    ji.set_first(pyrs[0])
    ti.set_first(tpyr(pyrs[0]))
    rj = rt = None
    for k in range(1, len(pyrs)):
        rj = ji.try_init(pyrs[k])
        rt = ti.try_init(tpyr(pyrs[k]))
        assert (rj is None) == (rt is None), k
        np.testing.assert_array_equal(ti.snap_streak, ji.snap_streak)
        if rj is not None:
            break
    assert rj is not None
    np.testing.assert_array_equal(rt.u.numpy(), np.asarray(rj.u))
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_allclose(rt.color.numpy(), np.asarray(rj.color),
                               atol=1e-3)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-3)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-3)
    m = np.asarray(rj.mask)
    rel = np.abs(rt.idepth.numpy()[m] / np.asarray(rj.idepth)[m] - 1.0)
    assert np.median(rel) < 1e-3
    assert np.quantile(rel, 0.99) < 1e-2
    assert rel.max() < 0.1
    assert rt.scale == pytest.approx(rj.scale, rel=0.1)


@pytest.fixture(scope="module")
def plane_pair():
    calib = jcam.Calib.create(200.0, 200.0, (W_IMG - 1) / 2.0,
                              (H_IMG - 1) / 2.0)
    ref_img = synth_image()
    ref = make_ref(ref_img, calib)
    xi_true = jnp.array([0.06, -0.04, 0.03, 0.02, -0.03, 0.025])
    R_true, t_true = jlie.se3_exp(xi_true)
    tgt = render_plane(ref_img, calib, R_true, t_true, a=1.1, b=-4.0)
    pyr = jpyr.build_pyramid(tgt, levels=LEVELS)
    return calib, ref, pyr, (R_true, t_true)


def test_calc_res_and_gs(plane_pair):
    """One level's 8x8 system at a perturbed pose: H and b to 1e-4 relative
    to their largest entry (sums over ~3.6k points in another order);
    energy and term counts to 1e-5 relative."""
    calib, ref, pyr, (R_true, t_true) = plane_pair
    R0, t0 = jlie.se3_exp(jnp.array([0.05, -0.03, 0.02, 0.015, -0.02, 0.02]))
    for lvl in (0, 2):
        cal_l = calib.at_level(lvl)
        H, b, st = jalign.calc_res_and_gs(
            pyr[lvl], cal_l, ref.clouds[lvl], R0, t0, jnp.asarray(1.05),
            jnp.asarray(-2.0), 9.0, 20.0, 1.0)
        Ht, bt, stt = talign.calc_res_and_gs(
            t(np.asarray(pyr[lvl])), convert.calib(cal_l, CPU),
            convert.point_cloud(ref.clouds[lvl], CPU), t(R0)[None],
            t(t0)[None], torch.tensor([1.05]), torch.tensor([-2.0]),
            9.0, 20.0, 1.0)
        Hn = np.asarray(H)
        np.testing.assert_allclose(Ht[0].numpy(), Hn, rtol=0,
                                   atol=1e-4 * np.abs(Hn).max())
        bn = np.asarray(b)
        np.testing.assert_allclose(bt[0].numpy(), bn, rtol=0,
                                   atol=1e-4 * np.abs(bn).max())
        for a, c in zip(st, stt):
            np.testing.assert_allclose(c[0].numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-6)


def test_track_multi_winner_and_pose(plane_pair):
    """The 4-candidate ladder: same winner index and valid flags, pose to
    1e-4, affine gain to 1e-4, packed flow stats to 1e-3 relative."""
    calib, ref, pyr, (R_true, t_true) = plane_pair
    R1, t1 = jlie.se3_exp(jnp.array([0.05, -0.03, 0.02, 0.015, -0.02,
                                     0.02]))
    R_c = np.stack([np.eye(3), np.asarray(R1), np.eye(3), np.eye(3)]) \
        .astype(np.float32)
    t_c = np.stack([np.zeros(3), np.asarray(t1), np.zeros(3),
                    np.zeros(3)]).astype(np.float32)
    mask_c = np.array([False, True, True, True])
    res, packed = jct.track_multi_jit(
        ref, pyr, calib, jnp.asarray(R_c), jnp.asarray(t_c),
        jnp.asarray(mask_c), jnp.zeros(()), jnp.zeros(()),
        jnp.asarray(2.0), levels=LEVELS)
    tres, tpacked = tct.track_multi(
        convert.tracker_ref(ref, CPU), tpyr(pyr), convert.calib(calib, CPU),
        t(R_c), t(t_c), t(mask_c), torch.zeros(()), torch.zeros(()),
        torch.tensor(2.0), levels=LEVELS)
    pj = jct.PackedTrack(np.asarray(packed), LEVELS)
    pt = tct.PackedTrack(tpacked.numpy(), LEVELS)
    assert pt.sel == pj.sel
    assert pt.valid == pj.valid and pt.any_valid == pj.any_valid
    np.testing.assert_allclose(pt.R, pj.R, atol=1e-4)
    np.testing.assert_allclose(pt.t, pj.t, atol=1e-4)
    assert pt.rho == pytest.approx(pj.rho, abs=1e-4)
    assert pt.b_aff == pytest.approx(pj.b_aff, abs=1e-2)
    np.testing.assert_allclose([pt.flow_t, pt.flow_rt],
                               [pj.flow_t, pj.flow_rt], rtol=1e-3)
    np.testing.assert_allclose(pt.level_terms, pj.level_terms, rtol=1e-3)
    err = jlie.se3_log(*jlie.se3_mul(jnp.asarray(pt.R), jnp.asarray(pt.t),
                                     *jlie.se3_inv(R_true, t_true)))
    assert float(jnp.abs(err).max()) < 1e-3
    np.testing.assert_allclose(tres.R.numpy(), pt.R, atol=0)


def test_track_identity_single(plane_pair):
    """`track` (batch of one) on the reference image itself: zero motion."""
    calib, ref, _, _ = plane_pair
    pyr = jpyr.build_pyramid(synth_image(), levels=LEVELS)
    res, packed = tct.track(
        convert.tracker_ref(ref, CPU), tpyr(pyr), convert.calib(calib, CPU),
        torch.eye(3), torch.zeros(3), torch.zeros(()), torch.zeros(()),
        levels=LEVELS)
    assert bool(res.valid)
    assert float(torch.linalg.norm(res.t)) < 1e-4
    jres, _ = jct.track_jit(ref, pyr, calib, jnp.eye(3), jnp.zeros(3),
                            jnp.zeros(()), jnp.zeros(()), levels=LEVELS)
    np.testing.assert_allclose(res.level_energy.numpy(),
                               np.asarray(jres.level_energy), atol=1e-3)
