"""One step of the VIO slice on the card, with kernel K1 live, against the
port's own CPU result.

The port runs the fixture of tests/test_full_vio.py (seed 3, 192x256) on
the CPU until the first keyframe completed after the IMU became ACTIVE; the
window, inertial states, pairs and extended prior of that moment go to the
card, and the VIO BA solve and the fused extended marginalization tail run
on both devices. K1 must launch on the card's path. Tolerances (6 LM
iterations of f32 on two devices, whose reductions and dense solves round
differently): the same iteration count, poses to 2e-4, scale and gravity
to 2e-4, velocities to 2e-3, idepths to 2e-3 relative, outlier masks
equal; victims and point masks equal, prior increments to 1e-4 of their
largest entry.

This file imports no JAX, so that the machine with the card, which has
none, runs it on its own:

    python -m pytest tests/test_torch_vio_cuda.py -m cuda --noconftest \
        -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.models import vio_ba
from dmvio_tpu_torch.ops import patch_sample
from dmvio_tpu_torch.utils import synthetic
from dmvio_tpu_torch.utils.camera import Calib

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

H, W, N_FRAMES = 192, 256, 48
CFG = dict(f_max=6, p_max=512, i_max=512, max_frames=4, levels=4,
           ba_iters=6)


def to(x, dev):
    """Move the tensors of nested tuples, NamedTuples and Calib to `dev`."""
    if isinstance(x, (torch.Tensor, Calib)):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to(a, dev) for a in x))
    if isinstance(x, tuple):
        return tuple(to(a, dev) for a in x)
    return x


def first_vio_keyframe_state():
    """The port's CPU run to the first keyframe completed after the IMU
    became ACTIVE: (VIOProblem, images, age_rank, newest slot)."""
    seq = synthetic.generate_vio_sequence(
        n_frames=N_FRAMES, frame_dt=0.05, h=H, w=W, s_dso=1.4,
        g2=(0.06, -0.04), accel_scale=0.8, rot_scale=0.45, seed=3,
        scene=synthetic.default_scene(2.0, device="cpu"))
    fs = full_system.FullSystem(seq["calib"], H, W, window.Config(**CFG),
                                device="cpu",
                                imu_calib=imu_system.IMUCalib())
    spf = seq["steps_per_frame"]
    kf_at_activation = None
    for i in range(N_FRAMES):
        chunk = None
        if i > 0:
            s0, s1 = (i - 1) * spf, i * spf
            chunk = (seq["acc"][s0:s1], seq["gyr"][s0:s1],
                     np.full(s1 - s0, seq["imu_dt"], np.float32))
        fs.add_frame(seq["images"][i], float(seq["timestamps"][i]),
                     imu_data=chunk)
        if fs._vio_mode():
            if kf_at_activation is None:
                kf_at_activation = fs.stats_kf
            elif fs.stats_kf > kf_at_activation:
                break
    assert fs._vio_mode() and fs.stats_kf > kf_at_activation
    slots = fs.win.slots_by_age()
    age_rank = np.full(CFG["f_max"], -1, np.int32)
    for r_, s_ in enumerate(slots):
        age_rank[s_] = r_
    return fs._vio_problem(), fs.win.images, age_rank, slots[-1]


def step(problem, images, age_rank, newest):
    res = vio_ba.optimize(problem, images, max_iters=CFG["ba_iters"])
    tail = vio_ba.vio_marg_fused(
        problem, images, torch.as_tensor(age_rank, device=images.device), 1,
        newest)
    return to(res, "cpu"), to(tail, "cpu")


@pytest.mark.cuda
def test_vio_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU form)")
    problem, images, age_rank, newest = first_vio_keyframe_state()
    cr, ct = step(problem, images, age_rank, newest)
    dev = torch.device("cuda")
    patch_sample.sample_patch3.launches = 0
    gr, gt = step(to(problem, dev), images.to(dev), age_rank, newest)
    assert patch_sample.sample_patch3.launches > 0
    assert int(gr.iters) == int(cr.iters)
    for a, b in ((gr.frames.R_cw, cr.frames.R_cw),
                 (gr.frames.t_cw, cr.frames.t_cw),
                 (gr.states.s_log, cr.states.s_log),
                 (gr.states.g2, cr.states.g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-4)
    torch.testing.assert_close(gr.states.v, cr.states.v, rtol=0, atol=2e-3)
    m = problem.base.points.mask
    torch.testing.assert_close(gr.points.idepth[m], cr.points.idepth[m],
                               rtol=2e-3, atol=0)
    assert torch.equal(gr.pair_outlier, cr.pair_outlier)
    assert torch.equal(gt[0], ct[0]) and int(ct[0][0]) >= 0
    for k in (1, 2, 3, 4):
        torch.testing.assert_close(
            gt[k], ct[k], rtol=0, atol=1e-4 * float(ct[k].abs().max()))
    assert torch.equal(gt[5].mask, ct[5].mask)
    assert torch.equal(gt[6], ct[6])
