"""Kernel K1's plain version against the reference's gather_patches +
sample3 (its XLA gather path on the CPU). The inputs, the tolerance and
the CUDA kernel's own test are in test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvio_tpu.ops import patch_sample as jps
from dmvio_tpu_torch.ops import patch_sample as tps
from test_torch_kernels_cuda import assert_same, make_case

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


def reference(img, u, v):
    outs = []
    for ti in range(img.shape[0]):
        p, x0, y0 = jps.gather_patches(jnp.asarray(img[ti]),
                                       jnp.asarray(u[ti, :, 4]),
                                       jnp.asarray(v[ti, :, 4]))
        outs.append([np.asarray(o) for o in jps.sample3(
            p, x0, y0, jnp.asarray(u[ti]), jnp.asarray(v[ti]))])
    return [np.stack([o[k] for o in outs]) for k in range(4)]


@pytest.mark.parametrize("kind", ["interior", "stretch", "edges",
                                  "nonfinite"])
def test_plain_matches_reference(kind):
    img, u, v = make_case(kind)
    got = tps.sample_patch3(torch.as_tensor(img), torch.as_tensor(u),
                            torch.as_tensor(v))
    ref = reference(img, u, v)
    assert_same(got, ref)
    if kind == "interior":
        assert ref[3].all()
    if kind == "stretch":
        assert 0 < ref[3].sum() < ref[3].size


def test_anchor_saturation_matches_reference():
    c = np.array([1e10, -1e10, np.inf, -np.inf, np.nan, -7.0, 5.5, 70.2],
                 np.float32)
    x0, y0 = jps._anchors(jnp.asarray(c), jnp.asarray(c[::-1].copy()),
                          48, 80)
    tx, ty = tps.anchors(torch.as_tensor(c), torch.as_tensor(c[::-1].copy()),
                         48, 80)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(x0))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y0))


def test_strided_view_input():
    """The main path passes channel 0 of a [F, 3, H, W] stack (a strided
    view); the result equals the contiguous one."""
    img, u, v = make_case("interior", seed=3)
    stack = torch.as_tensor(np.stack([img, img * 0.5, img * 0.25], 1))
    got = tps.sample_patch3(stack[:, 0], torch.as_tensor(u),
                            torch.as_tensor(v))
    ref = tps.sample_patch3(torch.as_tensor(img), torch.as_tensor(u),
                            torch.as_tensor(v))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
