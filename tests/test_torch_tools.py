"""The port's three measurement tools at a tiny size on the CPU:

* tools/scaling_probe.py: the point-axis work (linearize + accumulate) of
  one of n shards counts exactly 1/n of the one-device FLOPs, and the
  shards together do the one device's arithmetic;
* tools/profile_device.py: every stage of the VO pipeline runs under
  torch.profiler and prints its total (on the CPU: the operators' own
  time, labelled as such);
* tools/accuracy_probe.py: one configuration through a worker subprocess
  gives one JSON record with the reference probe's fields (its device
  count replaced by the device) and a metric trajectory.
"""

import numpy as np
import torch

from dmvio_tpu_torch.tools import accuracy_probe, profile_device
from dmvio_tpu_torch.tools import scaling_probe

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


def test_scaling_probe_counts_one_nth_per_shard(capsys):
    out = scaling_probe.main(["8", "P=512", "F=4", "H=64", "W=64",
                              "device=cpu"])
    assert out["point_work_flops_1dev"] > 0
    assert out["point_work_flops_1dev"] == 8 * out[
        "point_work_flops_per_shard"]
    assert out["ba_call_flops_all_shards"] > 0
    assert out["placed_bytes_per_shard"] < out["placed_bytes_1dev"]
    assert "ideal 8x" in capsys.readouterr().out


def test_profile_device_prints_every_stage(capsys):
    stages = profile_device.main([
        "H=128", "W=160", "frames=24", "device=cpu", "f_max=6", "p_max=256",
        "i_max=256", "max_frames=4", "levels=4", "ba_iters=4", "mesh=2"])
    text = capsys.readouterr().out
    assert [s["stage"] for s in stages] == list(profile_device.VO_STAGES)
    for s in stages:
        assert s["total_ms"] > 0 and s["top"], s["stage"]
        assert f"== {s['stage']}  (cpu op total" in text


def test_accuracy_probe_worker_record():
    rows = accuracy_probe.main(["seeds=3", "excite=0", "device=cpu",
                                "frames=40", "h=128", "w=160", "threads=1"])
    assert len(rows) == 1
    rec = rows[0]
    assert "error" not in rec, rec
    assert set(accuracy_probe.FIELDS) <= set(rec)
    assert rec["device"] == "cpu" and rec["seed"] == 3
    assert rec["phase"] == 2 and rec["lost"] == 0
    assert np.isfinite(rec["se3_tail"]) and np.isfinite(rec["sim3_tail"])
