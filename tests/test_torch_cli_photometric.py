"""Photometric calibration through the port's dataset CLI on the CPU, with
the gates of tests/test_cli_e2e.py::test_cli_photometric_calibration: a
sequence with a baked gamma response and lens vignette (the reference's
raw model I = G(t V B)) runs through gammaCalib= / vignette= and must
match the clean run's accuracy, on both loader paths (the Python loader,
and the native pipeline, which applies the same LUT and vignette division
in C++)."""

import pytest
import torch

from dmvio_tpu_torch.tools import make_synthetic
from test_torch_cli_e2e import SYNTH, _run, ate_of_run

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clean_ate(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("clean_data"))
    out = str(tmp_path_factory.mktemp("clean_out")) + "/"
    make_synthetic.main([f"out={data}", *SYNTH])
    _run(data, out)
    return ate_of_run(data, out)[0]


@pytest.fixture(scope="module")
def photometric_data(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("pc_data"))
    make_synthetic.main([f"out={data}", *SYNTH, "photometric=1"])
    return data


@pytest.mark.parametrize("native", [0, 1])
def test_cli_photometric_calibration(clean_ate, photometric_data, tmp_path,
                                     native):
    data = photometric_data
    out = str(tmp_path) + "/out_"
    summary = _run(data, out, (f"gammaCalib={data}/pcalib.txt",
                               f"vignette={data}/vignette.png",
                               f"nativeLoader={native}"))
    assert summary["native_loader"] is bool(native)
    ate_p, dist_p = ate_of_run(data, out)
    assert ate_p < 0.08 * dist_p + 0.02, (ate_p, dist_p)
    assert ate_p < 2.5 * clean_ate + 0.01, (ate_p, clean_ate)
