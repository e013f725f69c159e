"""Kernel K1 on the card against its plain PyTorch version, and the
inputs and tolerance that test_torch_patch_sample.py also holds the plain
version to against dmvio_tpu.

Tolerance: `ok` must be EQUAL (it decides which residuals are active);
values within atol 1e-4 on 0-255 intensities (the contractions sum the same
two non-zero terms, so only an FMA or summation-order ulp can differ);
NaN exactly where the reference has NaN.

This file imports no JAX, so that the machine with the card, which has
none, runs it on its own:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest \
        -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from dmvio_tpu_torch.ops import patch_sample as tps

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

ATOL = 1e-4


def make_case(kind: str, seed: int = 0):
    """img [T, H, W], u/v [T, N, K] (pattern index 4 is the centre)."""
    rng = np.random.default_rng(seed)
    T, H, W, N, K = 2, 48, 80, 96, 8
    img = rng.uniform(0, 255, (T, H, W)).astype(np.float32)
    if kind == "interior":
        uc = rng.uniform(10, W - 10, (T, N))
        vc = rng.uniform(10, H - 10, (T, N))
        off = rng.uniform(-3, 3, (T, N, K))
    elif kind == "stretch":
        uc = rng.uniform(10, W - 10, (T, N))
        vc = rng.uniform(10, H - 10, (T, N))
        off = rng.uniform(-12, 12, (T, N, K))
    elif kind == "edges":
        uc = rng.choice([-20.0, -3.5, 0.0, 0.7, 6.99, W - 8.5, W - 1.0, W,
                         W + 30.0], (T, N)) + rng.uniform(0, 0.9, (T, N))
        vc = rng.choice([-9.0, 0.0, 1.5, 7.2, H - 9.0, H - 1.0, H + 4.0],
                        (T, N)) + rng.uniform(0, 0.9, (T, N))
        off = rng.uniform(-4, 4, (T, N, K))
    elif kind == "nonfinite":
        specials = np.array([1e10, -1e10, np.inf, -np.inf, np.nan, 33.3])
        uc = rng.choice(specials, (T, N))
        vc = rng.choice(specials, (T, N))
        uc[:, :10] = rng.uniform(10, W - 10, (T, 10))
        off = rng.uniform(-3, 3, (T, N, K))
    else:
        raise ValueError(kind)
    u = (uc[..., None] + off).astype(np.float32)
    v = (vc[..., None] + off[..., ::-1]).astype(np.float32)
    u[..., 4] = uc
    v[..., 4] = vc
    return img, u, v


def assert_same(got, ref):
    gi, ggx, ggy, gok = (x.cpu().numpy() for x in got)
    ri, rgx, rgy, rok = ref
    np.testing.assert_array_equal(gok, rok)
    for g, r in ((gi, ri), (ggx, rgx), (ggy, rgy)):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["interior", "stretch", "edges",
                                  "nonfinite"])
def test_cuda_kernel_matches_plain(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU form)")
    img, u, v = make_case(kind)
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in (img, u, v)]
    before = tps.sample_patch3.launches
    got = tps.sample_patch3(*args)
    torch.cuda.synchronize()
    assert tps.sample_patch3.launches == before + 1
    ref = [x.cpu().numpy() for x in tps.sample_patch3_plain(*args)]
    assert_same(got, ref)
