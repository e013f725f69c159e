"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dmvio_tpu_torch
from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.ops import immature
from dmvio_tpu_torch.utils import synthetic
from dmvio_tpu_torch.utils.camera import Calib

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dmvio_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]

_ONE_FRAME = """
import json, sys
import torch
import dmvio_tpu_torch
from dmvio_tpu_torch.models import full_system, window
from dmvio_tpu_torch.utils import synthetic
from dmvio_tpu_torch.utils.camera import Calib
calib = Calib.create(100.0, 100.0, 63.5, 47.5, device="cpu")
scene = synthetic.default_scene(2.0, device="cpu")
img = synthetic.render(scene, torch.eye(3), torch.zeros(3), calib, 96, 128)
fs = full_system.FullSystem(calib, 96, 128,
                            window.Config(f_max=4, p_max=128, i_max=128,
                                          levels=3), device="cpu")
fs.add_frame(img, timestamp=0.0)
print(json.dumps({"shells": len(fs.shells),
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")
                                or m == "dmvio_tpu"
                                or m.startswith("dmvio_tpu."))}))
"""


def test_port_runs_without_jax():
    """A fresh interpreter imports the port and runs one CPU frame; no
    module of JAX or of dmvio_tpu gets loaded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _ONE_FRAME], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"shells": 1, "jax": []}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    text = path.read_text()
    assert "dmvio_tpu." not in text
    assert "import jax" not in text
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "dmvio_tpu"), (path, n)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert dmvio_tpu_torch.device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dmvio_tpu_torch.device()
    calib = Calib.create(100.0, 100.0, 63.5, 47.5, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        full_system.FullSystem(calib, 96, 128, window.Config(levels=3))


def test_realtime_defaults_to_cuda_and_raises_without_it():
    """The realtime pipeline, visual and inertial, runs on the card by
    default and never falls back to the CPU."""
    calib = Calib.create(100.0, 100.0, 63.5, 47.5, device="cpu")
    for imu_calib in (None, imu_system.IMUCalib()):
        if torch.cuda.is_available():
            fs = full_system.FullSystem(
                calib, 96, 128, window.Config(levels=3, realtime=True),
                imu_calib=imu_calib)
            assert fs.device.type == "cuda" and fs.calib.fx.is_cuda
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            full_system.FullSystem(
                calib, 96, 128, window.Config(levels=3, realtime=True),
                imu_calib=imu_calib)


@pytest.mark.parametrize("make", [
    lambda: Calib.create(100.0, 100.0, 63.5, 47.5),
    lambda: synthetic.default_scene(2.0),
    lambda: synthetic.room_scene(2.0),
    lambda: immature.empty_pool(16),
], ids=["Calib.create", "synthetic.default_scene", "synthetic.room_scene",
        "immature.empty_pool"])
def test_constructors_default_to_cuda(make):
    """Without `device`, a constructor puts its tensors on the card, and
    raises where there is none, as FullSystem does."""
    if torch.cuda.is_available():
        made = make()
        tensors = made if isinstance(made, tuple) else [made.fx]
        assert all(x.device.type == "cuda" for x in tensors)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


@pytest.mark.parametrize("kwargs", [
    dict(cfg=dict(mesh_devices=2, realtime=True)),
    dict(cfg=dict(mesh_devices=2)),
    dict(cfg=dict(mesh_devices=4, realtime=True),
         imu_calib=imu_system.IMUCalib()),
])
def test_unported_modes_refuse(kwargs):
    """Multi-device BA is not ported, in any mode (serial or realtime,
    visual or inertial)."""
    calib = Calib.create(100.0, 100.0, 63.5, 47.5, device="cpu")
    cfg = window.Config(levels=3, **kwargs.get("cfg", {}))
    with pytest.raises(NotImplementedError):
        full_system.FullSystem(calib, 96, 128, cfg, device="cpu",
                               imu_calib=kwargs.get("imu_calib"))


def _tiny_dataset(root):
    """A two-frame DSO folder (camera, times, IMU, PNG frames)."""
    from dmvio_tpu_torch.tools import make_synthetic

    make_synthetic.main([f"out={root}", "n=2", "w=128", "h=96",
                         "device=cpu"])
    return [f"files={root}/images", f"calib={root}/camera.txt",
            f"tsFile={root}/times.txt", f"imuFile={root}/imu.txt"]


@pytest.mark.parametrize("entry", ["run_dataset.run", "run_live.run",
                                   "io.dataset.load_undistorter",
                                   "io.dataset.open_dataset",
                                   "FullSystem.load_checkpoint"])
def test_io_entry_points_default_to_cuda(entry, tmp_path):
    """The IO slice's entry points run on the card unless device=cpu is
    passed, and raise without CUDA instead of falling back."""
    from dmvio_tpu_torch import run_dataset, run_live
    from dmvio_tpu_torch.io import dataset

    args = _tiny_dataset(str(tmp_path / "data"))
    files, calib = (a.split("=", 1)[1] for a in args[:2])
    ckpt = str(tmp_path / "ckpt.pkl")
    cpu = torch.device("cpu")
    fs = full_system.FullSystem(
        Calib.create(100.0, 100.0, 63.5, 47.5, device=cpu), 96, 128,
        window.Config(f_max=4, p_max=128, i_max=128, levels=3), device=cpu)
    fs.save_checkpoint(ckpt)
    prefix = f"resultsPrefix={tmp_path}/o_"
    call = {
        "run_dataset.run": lambda: run_dataset.run(
            args + [prefix, "quiet=1", "maxFrames=1", "levels=3"]),
        "run_live.run": lambda: run_live.run(
            [f"source=folder:{tmp_path}/data", args[1], prefix, "quiet=1",
             "maxFrames=1", "levels=3"]),
        "io.dataset.load_undistorter": lambda: dataset.load_undistorter(
            calib),
        "io.dataset.open_dataset": lambda: dataset.open_dataset(files, calib),
        "FullSystem.load_checkpoint": lambda: full_system.FullSystem
        .load_checkpoint(ckpt),
    }[entry]
    if torch.cuda.is_available():
        call()
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_no_port_file_builds_into_native(tmp_path, monkeypatch):
    """The port builds the shared C++ loader (native/dataloader.cpp) into
    build/native/ and never writes into native/: no port source runs the
    Makefile, and a fresh build leaves native/ as it was."""
    from dmvio_tpu_torch.io import native

    for path in PORT_FILES:
        text = path.read_text()
        assert '"make"' not in text and "'make'" not in text, path
    assert native.BUILD_DIR == ROOT / "build" / "native"
    before = {p.name: p.stat().st_mtime_ns
              for p in (ROOT / "native").iterdir()}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native_build")
    monkeypatch.setattr(native, "LIB", tmp_path / "native_build" / "lib.so")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available(), native.load_error()
    assert (tmp_path / "native_build" / "lib.so").exists()
    after = {p.name: p.stat().st_mtime_ns
             for p in (ROOT / "native").iterdir()}
    assert after == before
