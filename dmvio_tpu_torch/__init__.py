"""dmvio_tpu_torch: the PyTorch/CUDA port of the `dmvio_tpu` package.

A second package beside `dmvio_tpu` (the JAX reference). It keeps the
reference's layout (`utils/`, `ops/`, `models/`) and module names, so each
function has an obvious counterpart, but is written as plain PyTorch:
functions on tensors, NamedTuples of tensors for the window state, an
explicit batch dimension where JAX used `vmap`, and Python loops where JAX
used `fori_loop`/`while_loop`. The one Pallas kernel of the reference
(ops/patch_sample.py) is a hand-written CUDA kernel here (csrc/).

The port imports neither `jax` nor anything of `dmvio_tpu`.

Device rule: entry points run on CUDA unless the caller asks for the CPU
explicitly; with no CUDA device they raise instead of falling back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full-f32 products everywhere, mirroring dmvio_tpu/__init__.py
# (_set_matmul_precision): reduced-mantissa matmuls were measured to break
# the estimator there, and the tracker/BA normal equations span too much
# dynamic range for TF32's 10-bit mantissa.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def device(name: str | torch.device | None = None) -> torch.device:
    """Resolve the device an entry point runs on.

    None means "cuda". A CUDA device that is not available raises: the port
    never falls back to the CPU silently (tests pass device="cpu")."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dmvio_tpu_torch: CUDA is not available; pass device='cpu' "
            "explicitly to run on the CPU")
    return dev
