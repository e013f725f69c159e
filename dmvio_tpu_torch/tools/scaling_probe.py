"""Per-shard cost of the sharded window BA.

Counterpart of dmvio_tpu/tools/scaling_probe.py. The reference compiles
its BA for one device and for the virtual mesh and prints XLA's cost
analysis of each per-device program. PyTorch has no compiled-program cost
analysis, so this probe counts FLOPs with
torch.utils.flop_counter.FlopCounterMode (every matmul-like op the
program dispatches; kernel K1 and elementwise ops are not counted) on the
problem of synthetic.tiny_ba_problem at the reference operating point
(512x512, P=2048, F=8) or beyond (P=, F=):

  * the point-axis work one shard runs (linearize + accumulate) on one
    device against one of n shards: the ratio beside the ideal n;
  * a whole BA call (max_iters=2) on one device against the n shards
    together: sharding adds no arithmetic, so the ideal is 1;
  * the bytes placed on each shard's device (its slice of the points and
    the [F, P] incidence, plus the replicated frames and images).

FLOPs are counts, the same on any device; the probe runs on the card by
default (device=cpu runs it on the CPU). Time on the card is
tools/profile_device.py's job.

Usage:
    python -m dmvio_tpu_torch.tools.scaling_probe [n] [P=2048] [F=8] \
        [H=512] [W=512] [device=cpu]
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "fx"):                 # Calib
        return 16
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(x) for x in tree)
    return 0


def probe(n: int = 8, P: int = 2048, F: int = 8, H: int = 512, W: int = 512,
          device=None) -> dict:
    """FLOP and byte counts of the BA on one device against n shards."""
    from dmvio_tpu_torch.models import ba
    from dmvio_tpu_torch.ops import ba_solve, residuals
    from dmvio_tpu_torch.parallel import dist_ba
    from dmvio_tpu_torch.utils import synthetic

    problem, images = synthetic.tiny_ba_problem(P=P, F=F, H=H, W=W,
                                                device=device)
    dev = images.device
    placer = dist_ba.Placer([dev] * n)
    placed = placer.place_ba(problem)
    pimg = placer.place_images(images)

    def point_work(p, im):
        lin = residuals.linearize(p.frames, p.points, p.calib, im,
                                  p.pair_mask)
        return ba_solve.accumulate(lin, p.points.host, F)

    lin_1 = _flops(lambda: point_work(problem, images))
    lin_shard = [_flops(lambda: point_work(p, im))
                 for p, im in zip(placed.parts, pimg.parts)]
    call_1 = _flops(lambda: ba.optimize(problem, images, max_iters=2))
    call_n = _flops(lambda: ba.optimize(placed, pimg, max_iters=2))
    shard_bytes = _nbytes(placed.parts[0]) + _nbytes(pimg.parts[0])
    one_bytes = _nbytes(problem) + _nbytes(images)
    return {
        "device": str(dev), "n": n, "P": P, "F": F, "H": H, "W": W,
        "point_work_flops_1dev": lin_1,
        "point_work_flops_per_shard": max(lin_shard),
        "point_work_ratio": lin_1 / max(lin_shard),
        "ba_call_flops_1dev": call_1, "ba_call_flops_all_shards": call_n,
        "ba_call_ratio": call_1 / call_n,
        "placed_bytes_1dev": one_bytes, "placed_bytes_per_shard": shard_bytes,
    }


def main(argv=None) -> dict:
    args = list(argv if argv is not None else sys.argv[1:])
    pos = [a for a in args if "=" not in a]
    kv = dict(a.split("=", 1) for a in args if "=" in a)
    out = probe(n=int(pos[0]) if pos else 8, P=int(kv.get("P", 2048)),
                F=int(kv.get("F", 8)), H=int(kv.get("H", 512)),
                W=int(kv.get("W", 512)), device=kv.get("device"))
    n = out["n"]
    print(f"point-axis work (linearize + accumulate) FLOPs: 1-dev "
          f"{out['point_work_flops_1dev']:.4e}  per shard of {n} "
          f"{out['point_work_flops_per_shard']:.4e}  ratio "
          f"{out['point_work_ratio']:.3f}x (ideal {n}x)")
    print(f"whole BA call (max_iters=2) FLOPs: 1-dev "
          f"{out['ba_call_flops_1dev']:.4e}  all {n} shards "
          f"{out['ba_call_flops_all_shards']:.4e}  ratio "
          f"{out['ba_call_ratio']:.4f} (ideal 1)")
    print(f"bytes placed: 1-dev {out['placed_bytes_1dev']}  per shard "
          f"{out['placed_bytes_per_shard']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
