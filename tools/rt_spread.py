"""Run-to-run spread of chip_smoke.py's realtime phases on one card.

Builds the kernels, then runs the rt-vio-512 phase `--runs` times (3 by
default) with the rt-vo-512 phase between each two, through chip_smoke.py's
own phase functions: each prints its JSON summary (frames/s, keyframes,
ATE, host syncs, K1 launches). `--vio-frames N` runs the VIO phase over
the first N frames of bench.py's sequence instead of the smoke's 120 (the
ATE gates then scale with the path, as in the smoke). A phase that fails
its checks prints the failure and the script goes on.

    python3 tools/rt_spread.py [--runs N] [--vio-frames N]

Needs a CUDA device; imports nothing of JAX or of the JAX package.
"""

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from dmvio_tpu_torch import kernels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("rt_spread: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    runs = int(args[args.index("--runs") + 1]) if "--runs" in args else 3
    if "--vio-frames" in args:
        chip_smoke.RT_VIO_FRAMES = int(args[args.index("--vio-frames") + 1])
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    kernels.build(["patch_sample"])
    phases = []
    for k in range(runs):
        phases.append(("rt-vio-512", chip_smoke.phase_rt_vio))
        if k < runs - 1:
            phases.append(("rt-vo-512", chip_smoke.phase_rt_vo))
    for name, fn in phases:
        t = time.perf_counter()
        try:
            print(f"{name}: K1 launches {fn(dev)}", flush=True)
        except AssertionError:
            traceback.print_exc()
        print(f"{name}: took {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
