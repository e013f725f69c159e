"""The realtime pipeline's building blocks against dmvio_tpu, on seeded
numpy inputs.

* window_ops.track_candidates / rel_candidates and the keyframe pose guard
  (the reference's _guard_kf_pose and _carry_valid_pose are the same
  selection; the port keeps one function for both): f32 products of a few
  3x3 matrices, atol 1e-6.
* IMUSystem.predict_preview (host float64, the same filter code on the
  same chunk dicts): exactly equal, through the prefix-cache continuation
  too, and None on a chunk gap.
* FullSystem._kf_score_of (host float64): equal to 1e-12 relative.
* IMUSystem.kf_chunk_preint(upto_fid) (copied host float64
  preintegration): the split at a keyframe's frame id takes exactly the
  reference's chunks, and the preintegrations are exactly equal.
* utils/fetch.AsyncFetcher on the CPU: the tree keeps its structure, the
  values equal the tensors' .numpy(), the future is done at submit, and
  `exception(timeout)` on a copy that has not landed raises TimeoutError.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.models import full_system as jfs
from dmvio_tpu.models import imu_system as jimu
from dmvio_tpu.models import vio_coarse as jvc
from dmvio_tpu.models import window as jwin
from dmvio_tpu.models import window_ops as jwo
from dmvio_tpu.ops import preint as jpre
from dmvio_tpu.ops.residuals import BAFrames as JFrames
from dmvio_tpu_torch.models import full_system as tfs
from dmvio_tpu_torch.models import imu_system as timu
from dmvio_tpu_torch.models import vio_coarse as tvc
from dmvio_tpu_torch.models import window as twin
from dmvio_tpu_torch.models import window_ops as two
from dmvio_tpu_torch.ops.residuals import BAFrames as TFrames
from dmvio_tpu_torch.utils import fetch
from dmvio_tpu_torch.utils.lie import exp_so3_np

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

F = 6
ATOL = 1e-6


def rot(rng, scale=0.3):
    return exp_so3_np(rng.normal(0, scale, 3)).astype(np.float32)


def frames_pair(seed):
    """The same random window frames for both packages."""
    rng = np.random.default_rng(seed)
    R = np.stack([rot(rng) for _ in range(F)])
    t = rng.normal(0, 1, (F, 3)).astype(np.float32)
    aff = rng.normal(0, 0.1, (F, 2)).astype(np.float32)
    mask = np.ones(F, bool)
    arrs = (R, t, aff, R.copy(), t.copy(), aff.copy(), mask)
    return (JFrames(*(jnp.asarray(a) for a in arrs)),
            TFrames(*(torch.as_tensor(a) for a in arrs)), rng)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_track_candidates_match_reference(seed):
    jf, tf, rng = frames_pair(seed)
    poses = [(rot(rng), rng.normal(0, 1, 3).astype(np.float32))
             for _ in range(2)]
    slot = seed % F
    want = jwo.track_candidates(*(jnp.asarray(x) for p in poses for x in p),
                                jf, slot)
    got = two.track_candidates(*(torch.as_tensor(x) for p in poses
                                 for x in p), tf, slot)
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    assert got[2].tolist() == np.asarray(want[2]).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rel_candidates_match_reference(seed):
    jf, tf, rng = frames_pair(seed)
    R, t = rot(rng), rng.normal(0, 1, 3).astype(np.float32)
    slot = (seed + 2) % F
    want = jwo.rel_candidates(jnp.asarray(R), jnp.asarray(t), jf, slot)
    got = two.rel_candidates(torch.as_tensor(R), torch.as_tensor(t), tf,
                             slot)
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    assert got[2].tolist() == np.asarray(want[2]).tolist()


@pytest.mark.parametrize("anyv", [0.0, 1.0])
def test_keyframe_pose_guard_matches_reference(anyv):
    rng = np.random.default_rng(int(anyv) + 7)
    args = (rot(rng), rng.normal(0, 1, 3).astype(np.float32),
            rng.normal(0, 1, 2).astype(np.float32), rot(rng),
            rng.normal(0, 1, 3).astype(np.float32),
            rng.normal(0, 1, 2).astype(np.float32))
    got = tfs._guard_kf_pose(torch.tensor(anyv),
                             *(torch.as_tensor(a) for a in args))
    for ref_fn in (jfs._guard_kf_pose, jfs._carry_valid_pose):
        want = ref_fn(jnp.asarray(anyv), *(jnp.asarray(a) for a in args))
        for g, w in zip(got, want):
            close(g, w, atol=0.0)


def chunks(n, seed=3, samples=10):
    """Seeded IMU frame chunks, preintegrated by the reference (host f64)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        acc = (np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.3, (samples, 3))
               ).astype(np.float32)
        gyr = rng.normal(0, 0.2, (samples, 3)).astype(np.float32)
        dts = np.full(samples, 0.005, np.float32)
        out.append((acc, gyr, dts))
    return out


def active_pair():
    """Reference and port IMU systems in ACTIVE with the same belief."""
    rng = np.random.default_rng(11)
    belief = (rot(rng).astype(np.float64), rng.normal(0, 1, 3),
              rng.normal(0, 0.5, 3), rng.normal(0, 0.01, 6), 0.3,
              np.array([0.05, -0.02]))
    ref = jimu.IMUSystem(jimu.IMUCalib(), F)
    port = timu.IMUSystem(timu.IMUCalib(), F, torch.device("cpu"))
    ref.phase, port.phase = jimu.ACTIVE, timu.ACTIVE
    ref.coarse = jvc.init_from_ba(*belief)
    port.coarse = tvc.init_from_ba(*belief)
    return ref, port


def same_state(a, b):
    for f in ("R_cw", "t_cw", "v", "bias", "H", "g2"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.s_log == b.s_log


def test_predict_preview_matches_reference(monkeypatch):
    pres = [jpre.preintegrate_np(*c, np.zeros(6)) for c in chunks(5)]
    ref, port = active_pair()
    calls = []
    predict = tvc.predict
    monkeypatch.setattr(tvc, "predict",
                        lambda *a: calls.append(1) or predict(*a))
    want3 = ref.predict_preview(pres[:3])
    got3 = port.predict_preview(pres[:3])
    same_state(got3, want3)
    # Continuation from the cached prefix (the belief has not moved):
    # only the two new chunks are propagated.
    got5 = port.predict_preview(pres)
    assert len(calls) == 5
    fresh = timu.IMUSystem(timu.IMUCalib(), F, torch.device("cpu"))
    fresh.phase, fresh.coarse = timu.ACTIVE, port.coarse
    same_state(got5, fresh.predict_preview(pres))
    same_state(got5, ref.predict_preview(pres))
    # The preview does not move the belief.
    same_state(port.coarse, ref.coarse)
    # A chunk gap breaks the chain.
    assert port.predict_preview(pres[:2] + [None]) is None
    assert ref.predict_preview(pres[:2] + [None]) is None


@pytest.mark.parametrize("flow", [(0.0, 0.0, 0.0), (4.0, 9.0, 0.1),
                                  (250.0, 40.0, -0.3), (-1.0, 16.0, 0.02)])
def test_kf_score_matches_reference(flow):
    def stub(cfg):
        return types.SimpleNamespace(cfg=cfg, w=256, h=192)
    want = jfs.FullSystem._kf_score_of(
        stub(jwin.Config(rt_kf_density=3.0)), *flow)
    got = tfs.FullSystem._kf_score_of(
        stub(twin.Config(rt_kf_density=3.0)), *flow)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("upto", [None, 12, 14])
def test_kf_chunk_split_matches_reference(upto):
    ref = jimu.IMUSystem(jimu.IMUCalib(), F)
    port = timu.IMUSystem(timu.IMUCalib(), F, torch.device("cpu"))
    for fid, c in zip(range(10, 16), chunks(6, seed=5)):
        ref.add_frame_imu(*c, fid=fid)
        port.add_frame_imu(*c, fid=fid)
    _, want = ref.kf_chunk_preint(upto)
    got = port.kf_chunk_preint(upto)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert port._kf_fids == ref._kf_fids
    if upto is not None:
        assert port._kf_fids == list(range(upto + 1, 16))
        # The rest of the buffer is the next pair's.
        _, want = ref.kf_chunk_preint()
        got = port.kf_chunk_preint()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert port._kf_fids == [] and port.kf_chunk_preint() is None


class _NotLanded:
    """An event whose copy never lands."""

    def query(self):
        return False


def test_fetcher_keeps_the_tree_and_values():
    from dmvio_tpu_torch.models import vio_ba

    st = vio_ba.VIOStates(*(torch.randn(3, 2) for _ in range(10)))
    tree = (torch.arange(5), (st, None, [torch.tensor(True)]),
            torch.tensor(2.5))
    for enabled in (True, False):
        fut = fetch.AsyncFetcher(enabled=enabled).submit(tree)
        assert fut.done()
        assert fut.exception(timeout=0.0) is None
        a, (s, none, (flag,)), x = fut.result()
        assert none is None and isinstance(s, vio_ba.VIOStates)
        np.testing.assert_array_equal(a, tree[0].numpy())
        for got, want in zip(s, st):
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, want.numpy())
        assert bool(flag) and float(x) == 2.5


def test_fetch_future_times_out_while_in_flight():
    fut = fetch.FetchFuture(np.zeros(1), _NotLanded())
    assert not fut.done()
    with pytest.raises(TimeoutError):
        fut.exception(timeout=0.01)
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
