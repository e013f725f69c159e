"""Parity of the port's sharded window BA (dmvio_tpu_torch/parallel) with
dmvio_tpu/parallel/dist_ba.py, as tests/test_dist_ba.py holds the
reference: the driver entry problem (`__graft_entry__._tiny_problem`,
P=512) carried into the port with dmvio_tpu_torch.convert, the port on 8
shards of the CPU against the port on one device and against JAX's
optimize_dist over conftest's 8 virtual devices.

Tolerances (max_iters=3, the reference test's): energy rtol 2e-3, t_cw
atol 2e-4, idepth rtol 5e-3 / atol 1e-4. The marginalization fold is
a sum of per-shard partials of a ~1e9-magnitude system: to 1e-4 of its
largest entry; victims and point masks exactly. frame_energy_th gathers
its sharded inputs whole, so it equals the single-device call exactly.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from dmvio_tpu.models import ba as jba
from dmvio_tpu.parallel import dist_ba as jdist
from dmvio_tpu.utils import synthetic as jsyn
from dmvio_tpu_torch import convert
from dmvio_tpu_torch.models import ba, window
from dmvio_tpu_torch.parallel import dist_ba, dist_init
from dmvio_tpu_torch.utils import synthetic
from dmvio_tpu_torch.utils.camera import Calib

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def to_port(jprob):
    T = lambda x: convert.tensor(np.asarray(x), CPU)  # noqa: E731
    return ba.BAProblem(
        frames=convert.frames(jprob.frames, CPU),
        points=convert.points(jprob.points, CPU),
        calib=convert.calib(jprob.calib, CPU), calib0=T(jprob.calib0),
        HM=T(jprob.HM), bM0=T(jprob.bM0), prior_diag=T(jprob.prior_diag),
        pair_mask=T(jprob.pair_mask).to(torch.bool))


@pytest.fixture(scope="module")
def tiny():
    jprob, jimg = ge._tiny_problem(P=512)
    return jprob, jimg, to_port(jprob), convert.tensor(np.asarray(jimg), CPU)


def cpu_placer(n):
    return dist_ba.Placer(dist_ba.make_mesh(n, device="cpu"))


@pytest.mark.parametrize("n,shape", [(8, (4, 2)), (2, (1, 2)), (3, (3, 1))])
def test_mesh_shapes(n, shape):
    m = dist_ba.make_mesh(n, device="cpu")
    assert m.devices.size == n and m.devices.shape == shape
    assert m.axis_names == ("dp", "mp")
    assert m.devices.shape == jdist.make_mesh(n).devices.shape


def test_tiny_problem_helper_matches_reference(tiny):
    """synthetic.tiny_ba_problem builds the reference's problem (same
    recipe, same numpy seed) to float32 rounding; orbit_poses likewise."""
    jprob, jimg, _, _ = tiny
    tprob, timg = synthetic.tiny_ba_problem(P=512, device="cpu")
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0,
                               atol=1e-3)
    for a, b in zip(tprob.points, jprob.points):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)
    for a, b in zip(tprob.frames, jprob.frames):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_array_equal(tprob.pair_mask.numpy(),
                                  np.asarray(jprob.pair_mask))
    Rj, tj = jsyn.orbit_poses(6)
    Rt, tt = synthetic.orbit_poses(6, device="cpu")
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)


def test_sharded_matches_single_and_reference(tiny):
    jprob, jimg, tprob, timg = tiny
    single = ba.optimize(tprob, timg, max_iters=3)
    pl = cpu_placer(8)
    sharded = pl.gather(ba.optimize(pl.place_ba(tprob),
                                    pl.place_images(timg), max_iters=3))
    ref = jdist.optimize_dist(jprob, jimg, jdist.make_mesh(8), max_iters=3)
    for got, want in ((sharded, single), (sharded, ref)):
        np.testing.assert_allclose(float(got.energy), float(want.energy),
                                   rtol=2e-3)
        np.testing.assert_allclose(np.asarray(got.frames.t_cw),
                                   np.asarray(want.frames.t_cw), atol=2e-4)
        np.testing.assert_allclose(np.asarray(got.points.idepth),
                                   np.asarray(want.points.idepth),
                                   rtol=5e-3, atol=1e-4)
    assert sharded.pair_outlier.shape == single.pair_outlier.shape
    assert torch.equal(sharded.pair_outlier, single.pair_outlier)


def test_sharded_two_devices(tiny):
    _, _, tprob, timg = tiny
    out = dist_ba.optimize_dist(tprob, timg, dist_ba.make_mesh(2,
                                                               device="cpu"),
                                max_iters=2)
    assert np.isfinite(float(out.energy))
    assert out.points.idepth.shape == tprob.points.idepth.shape


def test_sharded_marginalization_matches_single(tiny):
    """marg_fused and the active-point fold (the point marginalization the
    PGBA event uses) on 8 shards against the single dispatch."""
    _, _, tprob, timg = tiny
    pl = cpu_placer(8)
    age = torch.arange(4, dtype=torch.int32)
    m_1 = ba.marg_fused(tprob, timg, age, 1, 3)
    m_8 = pl.gather(ba.marg_fused(pl.place_ba(tprob), pl.place_images(timg),
                                  age, 1, 3))
    assert torch.equal(m_8[0], m_1[0]) and int(m_1[0][0]) >= 0
    for k in (1, 2):
        torch.testing.assert_close(
            m_8[k], m_1[k], rtol=0, atol=1e-4 * float(m_1[k].abs().max()))
    assert torch.equal(m_8[3].mask, m_1[3].mask)
    assert torch.equal(m_8[4], m_1[4])
    assert float(m_8[5]) == float(m_1[5]) and float(m_8[6]) == float(m_1[6])
    h_1 = ba.marginalization_update(tprob, timg, tprob.points.mask)
    h_8 = ba.marginalization_update(pl.place_ba(tprob),
                                    pl.place_images(timg),
                                    pl.point_sharded(tprob.points.mask))
    for a, b in zip(h_8, h_1):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_frame_energy_th_sharded_is_exact():
    rng = np.random.default_rng(3)
    e = torch.as_tensor(rng.exponential(300.0, (6, 512)).astype(np.float32))
    ok = torch.as_tensor(rng.random((6, 512)) < 0.6)
    ok[5] = False                       # a frame without active pairs
    pl = cpu_placer(8)
    th_1 = ba.frame_energy_th(e, ok)
    th_8 = ba.frame_energy_th(pl.pair_sharded(e), pl.pair_sharded(ok))
    assert torch.equal(th_8, th_1)
    np.testing.assert_allclose(
        th_1.numpy(), np.asarray(jba.frame_energy_th(e.numpy(), ok.numpy())),
        rtol=1e-6)


def test_placement_layout():
    """Points split into contiguous equal shards in order, the images are
    placed once per stack (held by identity), and a point capacity that
    does not divide raises."""
    pl = cpu_placer(4)
    x = torch.arange(32.0).reshape(16, 2)
    parts = pl.point_sharded(x).parts
    assert [p.shape for p in parts] == [(4, 2)] * 4
    assert torch.equal(torch.cat(parts), x)
    assert all(p.is_contiguous() for p in pl.pair_sharded(
        torch.zeros(3, 16, 8)).parts)
    img = torch.zeros(2, 3, 8, 8)
    assert pl.place_images(img) is pl.place_images(img)
    assert pl.place_images(img.clone()) is not pl.place_images(img)
    with pytest.raises(ValueError):
        pl.point_sharded(torch.zeros(10))


def test_dist_init_contract(monkeypatch):
    for k in ("DMVIO_COORDINATOR", "DMVIO_NUM_PROCESSES", "DMVIO_PROCESS_ID",
              "DMVIO_DIST"):
        monkeypatch.delenv(k, raising=False)
    assert dist_init.maybe_initialize(device="cpu") is False
    assert dist_init.is_multiprocess() is False
    monkeypatch.setenv("DMVIO_COORDINATOR", "localhost:1")
    monkeypatch.setenv("DMVIO_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="DMVIO_PROCESS_ID"):
        dist_init.maybe_initialize(device="cpu")


def test_newest_slot():
    win = window.Window(Calib.create(50.0, 50.0, 15.5, 11.5, device="cpu"),
                        24, 32, window.Config(f_max=4, p_max=16, i_max=16))
    win.slot_frame_id = [7, None, 12, 3]
    assert win.newest_slot() == 2
