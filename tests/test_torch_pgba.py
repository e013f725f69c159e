"""The port's copies of the delayed-marginalization log and PGBA
(dmvio_tpu_torch/models/{delayed,pgba}.py, host float64) against
dmvio_tpu's, on `build_world` / `make_log` of tests/test_pgba.py (24
keyframes of a simulated trajectory, pose-anchoring event quadratics and
symbolic IMU pairs).

Both run the same NumPy code on the same inputs, so every number agrees to
1e-12 of its largest entry (exactly where no LAPACK call intervenes); the
port also passes the reference test's recovery gates.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dmvio_tpu.models import delayed as jdl
from dmvio_tpu.models import pgba as jpg
from dmvio_tpu.models import vio_coarse as jvc
from dmvio_tpu_torch.models import delayed as tdl
from dmvio_tpu_torch.models import pgba as tpg
from test_pgba import G2_GT, N_KF, S_GT, build_world, make_log

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


def same(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1e-300))


def port_kfs(kfs):
    return {k: tdl.KFState(**dataclasses.asdict(v)) for k, v in kfs.items()}


def port_log(log):
    """The same delayed log built from the port's own types."""
    out = tdl.DelayedLog(delay=log.delay, R_cb=log.R_cb, t_cb=log.t_cb)
    for ev, p in zip(log.events, log.pairs):
        out.events.append(tdl.MargEvent(
            victim=ev.victim, fids=list(ev.fids), H=ev.H.copy(),
            b0=ev.b0.copy(), fej=port_kfs(ev.fej), s_log0=ev.s_log0,
            g20=ev.g20.copy()))
        out.pairs.append(tdl.SymbolicPair(fid_i=p.fid_i, fid_j=p.fid_j,
                                          pre=p.pre))
    return out


def same_result(t, j):
    assert t.ok == j.ok and t.n_kfs == j.n_kfs
    same(t.s_log, j.s_log)
    same(t.g2, j.g2)
    same(t.s_var, j.s_var, 1e-9)
    same(t.energy, j.energy, 1e-9)
    assert t.states.keys() == j.states.keys()
    for f in t.states:
        for name in ("R_cw", "t_cw", "v", "bg", "ba"):
            same(getattr(t.states[f], name), getattr(j.states[f], name),
                 1e-9)


@pytest.mark.parametrize("rig", ["identity", "rotated"])
def test_pgba_is_the_reference_copy(rig):
    R_cb = t_cb = None
    if rig == "rotated":
        R_cb = jvc._exp_so3(np.array([np.pi / 2, 0.0, 0.0]))
        t_cb = np.array([0.08, -0.04, 0.05])
    kfs, pres = build_world(R_cb=R_cb, t_cb=t_cb)
    jlog = make_log(kfs, pres, R_cb=R_cb, t_cb=t_cb)
    tlog = port_log(jlog)
    window = list(range(N_KF - 4, N_KF))
    args = (np.log(S_GT) + 0.4, G2_GT + np.array([-0.05, 0.04]))
    jres = jpg.run(jlog, {k: kfs[k] for k in window}, None, *args, iters=15)
    tres = tpg.run(tlog, {k: port_kfs(kfs)[k] for k in window}, None, *args,
                   iters=15)
    same_result(tres, jres)
    assert tres.ok
    assert abs(np.exp(tres.s_log) - S_GT) / S_GT < 0.05
    assert np.linalg.norm(tres.g2 - G2_GT) < 0.03
    assert tres.s_var < 0.05


def test_delayed_advance_and_rebuild_are_the_reference_copy():
    """Events pushed past the delay fold into the tail identically; the
    prior rebuilt at the PGBA point is the same PSD quadratic."""
    kfs, pres = build_world()
    full = make_log(kfs, pres)
    jlog, tlog = jdl.DelayedLog(delay=6), tdl.DelayedLog(delay=6)
    for ev, p in zip(list(full.events), full.pairs):
        jlog.record_event(ev, [p])
    for ev, p in zip(port_log(full).events, port_log(full).pairs):
        tlog.record_event(ev, [p])
    assert len(tlog.events) == len(jlog.events) <= 6
    same(tlog.tail_H, jlog.tail_H)
    same(tlog.tail_b0, jlog.tail_b0)
    assert tlog.delayed_fids() == jlog.delayed_fids()

    log_j = make_log(kfs, pres)
    log_t = port_log(log_j)
    window = list(range(N_KF - 4, N_KF))
    res_j = jpg.run(log_j, {k: kfs[k] for k in window}, None,
                    np.log(S_GT) + 0.4, G2_GT, iters=15)
    res_t = tpg.run(log_t, {k: port_kfs(kfs)[k] for k in window}, None,
                    np.log(S_GT) + 0.4, G2_GT, iters=15)
    same_result(res_t, res_j)
    target_j = {k: kfs[k] for k in window}
    H_j, b_j = log_j.rebuild_prior(window, target_j, res_j.states,
                                   res_j.s_log, res_j.g2)
    H_t, b_t = log_t.rebuild_prior(window, port_kfs(target_j), res_t.states,
                                   res_t.s_log, res_t.g2)
    same(H_t, H_j, 1e-9)
    same(b_t, b_j, 1e-9)
    assert H_t[0, 0] > 1e2 and abs(-b_t[0] / H_t[0, 0]) < 0.05
