"""The port's IO layer beside the engine, on the CPU: settings and the
shipped configs (the analogue of tests/test_configs.py), the headless and
HTTP viewers and the depth publish (tests/test_viewer.py), the live layer
(the interpolator, container, skipper and saver tests of
tests/test_live_and_aux.py), and the CLI's usedSettings.txt keys against
the JAX CLI's for the same arguments."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from dmvio_tpu_torch.io import image_rw, live
from dmvio_tpu_torch.io import output_wrapper as ow
from dmvio_tpu_torch.models import full_system, imu_system, window
from dmvio_tpu_torch.ops import preint
from dmvio_tpu_torch.utils import lie, synthetic
from dmvio_tpu_torch.utils.camera import Calib
from dmvio_tpu_torch.utils.settings import SettingsUtil

# The suite runs several workers on few cores: one intra-op thread per
# worker keeps PyTorch's OpenMP pool from contending with XLA's.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["tumvi.yaml", "euroc.yaml", "4seasons.yaml",
           "t265_noise_tumvi.yaml", "ablations/noPGBA.yaml",
           "ablations/noMargReplacement.yaml",
           "ablations/noInitialReplacement.yaml"]


# -- settings and configs (tests/test_configs.py) ---------------------------


def test_reference_named_settings_apply(tmp_path):
    su = SettingsUtil()
    su.register("accelerometer_noise_density", 2.0e-3)
    su.register("init_transitionModel", 2)
    yaml_path = tmp_path / "s.yaml"
    yaml_path.write_text(
        "accelerometer_noise_density: 0.1\n"
        "init_transitionModel: 5\n"
        "unknown_key_is_ignored: 1\n")
    su.try_read_yaml(str(yaml_path))
    assert su["accelerometer_noise_density"] == 0.1
    assert su["init_transitionModel"] == 5
    # Command line wins over yaml.
    su.parse_arg("init_transitionModel=4")
    su.try_read_yaml(str(yaml_path))
    assert su["init_transitionModel"] == 4


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_configs_parse(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        data = yaml.safe_load(f)
    assert data["accelerometer_noise_density"] > 0
    if name == "ablations/noPGBA.yaml":
        assert data["init_transitionModel"] == 5


def test_noise_model_flows_from_calib():
    old = (preint.NOISE.sigma_gyro, preint.NOISE.sigma_acc,
           preint.NOISE.sigma_gyro_walk, preint.NOISE.sigma_acc_walk,
           preint.NOISE.sigma_integration)
    try:
        imu_system.IMUSystem(
            imu_system.IMUCalib(sigma_gyro=1e-3, sigma_acc=5e-3), f_max=4,
            device=torch.device("cpu"))
        assert preint.NOISE.sigma_gyro == 1e-3
        assert preint.NOISE.sigma_acc == 5e-3
        # Covariance scales with the density (continuous-time model).
        acc = np.tile(np.array([0.0, 0.0, 9.8082]), (5, 1))
        gyr = np.zeros((5, 3))
        dts = np.full(5, 0.005)
        pre_a = preint.preintegrate_np(acc, gyr, dts, np.zeros(6))
        preint.set_noise(sigma_acc=10e-3)
        pre_b = preint.preintegrate_np(acc, gyr, dts, np.zeros(6))
        ratio = pre_b["cov"][3, 3] / max(pre_a["cov"][3, 3], 1e-30)
        assert abs(ratio - 4.0) < 0.1   # (10/5)^2
    finally:
        preint.set_noise(*old)


def test_transition_model_5_disables_pgba():
    sys5 = imu_system.IMUSystem(imu_system.IMUCalib(transition_model=5),
                                f_max=4, device=torch.device("cpu"))
    sys5.phase = imu_system.ACTIVE
    sys5.states = object()   # sentinel; must not be touched
    assert sys5.maybe_run_pgba(None, [None] * 4) is False
    assert sys5.kf_since_pgba == 0   # not even counted


def _tiny_dataset(root):
    from dmvio_tpu_torch.tools import make_synthetic

    make_synthetic.main([f"out={root}", "n=2", "w=128", "h=96",
                         "device=cpu"])


def _settings_of(path):
    out = {}
    with open(path) as f:
        for ln in f:
            key, rest = ln.split("=", 1)
            out[key] = rest.split("   [")[0]
    return out


# Keys of the port's CLI that the JAX CLI has not: the device switch.
PORT_ONLY_KEYS = {"device"}
# Keys of the JAX CLI that the port's CLI lacks: none.
PORT_LACKS_KEYS = set()


def test_used_settings_match_jax_cli(tmp_path):
    """Both CLIs on the same arguments (one frame; a yaml config, a
    preset and command-line overrides) record the same settings."""
    from dmvio_tpu import run_dataset as jrun
    from dmvio_tpu_torch import run_dataset as trun

    data = tmp_path / "data"
    _tiny_dataset(str(data))
    argv = [f"files={data}/images", f"calib={data}/camera.txt",
            f"tsFile={data}/times.txt", f"imuFile={data}/imu.txt",
            "useimu=1", "preset=2", "maxFrames=1", "quiet=1",
            "nativeLoader=0", "ba_iters=3", "levels=4",
            f"settingsFile={REPO}/configs/tumvi.yaml"]
    jrun.run(argv + [f"resultsPrefix={tmp_path}/j_"])
    trun.run(argv + [f"resultsPrefix={tmp_path}/t_", "device=cpu"])
    js = _settings_of(tmp_path / "j_usedSettings.txt")
    ts = _settings_of(tmp_path / "t_usedSettings.txt")
    assert set(js) - set(ts) == PORT_LACKS_KEYS
    assert set(ts) - set(js) == PORT_ONLY_KEYS
    diff = {k: (js[k], ts[k]) for k in js if k in ts
            and k != "resultsPrefix" and js[k] != ts[k]}
    assert diff == {}
    assert ts["device"] == "cpu" and ts["ba_iters"] == "3"
    for f in ("result.txt", "resultKFs.txt", "timings.txt"):
        assert os.path.getsize(tmp_path / f"t_{f}") > 0


# -- viewers (tests/test_viewer.py) -----------------------------------------


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 255, (37, 53), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    image_rw.write_png(p, gray)
    back = image_rw.read_png_gray(p)
    assert back.shape == (37, 53)
    assert np.abs(back - gray.astype(np.float32)).max() < 1e-3

    rgb = rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
    p2 = str(tmp_path / "c.png")
    image_rw.write_png(p2, rgb)
    assert os.path.getsize(p2) > 0


def test_headless_viewer_artifacts(tmp_path):
    from dmvio_tpu_torch.io.viewer import HeadlessViewer

    v = HeadlessViewer(str(tmp_path / "viz"))
    rng = np.random.default_rng(1)
    R = np.eye(3)
    for k in range(30):
        t = np.array([0.02 * k, 0.001 * k * k, 0.01 * k])
        v.publish_cam_pose(k, 0.05 * k, R, t)
    v.publish_keyframes({0: (R, np.zeros(3)),
                         10: (R, np.array([0.2, 0.1, 0.1]))})
    v.publish_system_status(1)
    v.publish_transform_dso_to_imu(1.4, np.zeros(2))
    img = rng.integers(0, 255, (48, 64)).astype(np.float32)
    u = rng.uniform(2, 62, 100)
    w = rng.uniform(2, 46, 100)
    d = rng.uniform(0.3, 3.0, 100)
    v.push_depth_image(10, u, w, d, img=img)
    v.join()
    out = tmp_path / "viz"
    assert (out / "index.html").exists()
    assert (out / "trajectory.png").exists()
    assert (out / "depth_kf000010.png").exists()


class _Sink(ow.Output3DWrapper):
    """Records every event; asks for depth images."""

    wants_depth_images = True

    def __init__(self):
        self.depths, self.graphs, self.poses, self.statuses = [], [], [], []
        self.kf_poses, self.energy_th = [], []

    def push_depth_image(self, frame_id, u, v, idepth, img=None):
        self.depths.append((frame_id, len(u), img is not None,
                            bool(np.all(np.isfinite(idepth)))))

    def publish_graph(self, conn):
        self.graphs.append(conn)

    def publish_cam_pose(self, frame_id, timestamp, R_cw, t_cw):
        self.poses.append((frame_id, timestamp))

    def publish_system_status(self, status):
        self.statuses.append(status)

    def publish_keyframes(self, kf_poses):
        self.kf_poses.append(sorted(kf_poses))

    def publish_frame_energy_th(self, frame_id, th):
        self.energy_th.append((frame_id, th))


def test_full_system_publishes_depth():
    """End-to-end: a wants_depth_images wrapper receives depth maps, the
    graph, every tracked pose and the status (serial VO, 96x128)."""
    H, W = 96, 128
    cpu = torch.device("cpu")
    calib = Calib.create(80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5, device=cpu)
    scene = synthetic.default_scene(depth=2.0, device=cpu)
    cfg = window.Config(f_max=5, p_max=256, i_max=256, max_frames=4,
                        levels=3, ba_iters=3)
    fs = full_system.FullSystem(calib, H, W, cfg, device=cpu)
    sink = _Sink()
    fs.output_wrappers.append(sink)
    for i in range(26):
        c = np.array([0.05 * i, 0.012 * i, 0.006 * i])
        w_vec = torch.tensor([0.004 * i, -0.006 * i, 0.002 * i])
        R = lie.so3_exp(w_vec)
        img = synthetic.render(scene, R, -R @ torch.tensor(c, dtype=R.dtype),
                               calib, H, W)
        fs.add_frame(img, 0.05 * i)
    assert fs.initialized
    assert len(sink.depths) > 0
    fid, npts, has_img, finite = sink.depths[-1]
    assert npts > 20 and has_img and finite
    assert fid == fs.ref_kf_id
    assert len(sink.graphs) > 0 and len(sink.graphs[-1]) >= 2
    assert len(sink.kf_poses) == len(sink.depths) == fs.stats_kf - 2
    assert len(sink.energy_th) == len(sink.depths)
    # Every tracked frame after the initializer's; the status once.
    tracked = [sh.frame_id for sh in fs.shells
               if sh.frame_id > min(fs.kf_poses)]
    assert [p[0] for p in sink.poses] == tracked[-len(sink.poses):]
    assert sink.statuses == [ow.VISUAL_ONLY]


def test_live_viewer_serves_state():
    """LiveViewer: the HTTP counterpart of the reference's live Pangolin
    observer serves the page, the state JSON and the depth JPEG while
    events stream in (port 0: an ephemeral port)."""
    from dmvio_tpu_torch.io.live_viewer import LiveViewer

    v = LiveViewer(port=0)
    try:
        base = f"http://127.0.0.1:{v.port}"
        for i in range(5):
            v.publish_cam_pose(i, 0.05 * i, np.eye(3),
                               np.array([0.01 * i, 0, 0]))
        v.publish_keyframes({0: (np.eye(3), np.zeros(3)),
                             3: (np.eye(3), np.array([0.03, 0, 0]))})
        v.publish_system_status(ow.VISUAL_INERTIAL)
        v.publish_transform_dso_to_imu(0.42, np.zeros(2))
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (48, 64)).astype(np.float32)
        v.push_depth_image(3, np.array([5, 10, 20]), np.array([7, 14, 28]),
                           np.array([0.5, 1.0, 2.0]), img=img)

        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"dmvio_tpu_torch live" in page
        st = json.loads(urllib.request.urlopen(
            base + "/state.json", timeout=10).read())
        assert st["frame"] == 4 and len(st["traj"]) == 5
        assert st["n_kfs"] == 2 and st["status"] == ow.VISUAL_INERTIAL
        assert abs(st["scale"] - 0.42) < 1e-9
        jpg = urllib.request.urlopen(base + "/depth.jpg", timeout=10).read()
        assert jpg[:2] == b"\xff\xd8"   # JPEG magic
    finally:
        v.close()


# -- live layer (tests/test_live_and_aux.py) --------------------------------


def test_acc_interpolated_onto_gyro_timestamps():
    fc = live.FrameContainer()
    it = live.IMUInterpolator(fc)
    # acc at 0, 10ms; gyro at 5ms -> acc interpolated to midpoint.
    it.add_acc_data([0.0, 0.0, 0.0], 0.000)
    it.add_acc_data([2.0, 0.0, 0.0], 0.010)
    it.add_gyr_data([0.1, 0.0, 0.0], 0.005)
    it.add_image(np.zeros((4, 4)), 0.010)
    fr = fc.get_frame()
    assert fr is not None
    assert len(fr.dts) >= 1
    np.testing.assert_allclose(fr.acc[0], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(fr.gyr[0], [0.1, 0.0, 0.0], atol=1e-6)


def test_chunk_ends_at_image_timestamp():
    fc = live.FrameContainer()
    it = live.IMUInterpolator(fc)
    for k in range(10):
        t = k * 0.005
        it.add_acc_data([1.0, 2.0, 3.0], t)
        it.add_gyr_data([0.1, 0.2, 0.3], t)
    it.add_image(None, 0.033)
    fr = fc.get_frame()
    # dts sum exactly to the frame interval span.
    assert abs(fr.dts.sum() - (0.033 - (0.0 - 0.005))) < 0.02


def test_out_of_order_tolerated():
    fc = live.FrameContainer()
    it = live.IMUInterpolator(fc)
    it.add_gyr_data([0.1, 0, 0], 0.010)
    it.add_gyr_data([0.2, 0, 0], 0.005)   # late arrival
    it.add_acc_data([1, 0, 0], 0.004)
    it.add_acc_data([1, 0, 0], 0.012)
    it.add_image(None, 0.015)
    fr = fc.get_frame()
    assert (np.diff(np.cumsum(fr.dts)) >= 0).all()


def test_skip_concatenates_imu():
    fc = live.FrameContainer()
    for k in range(3):
        fc.add_frame(live.LiveFrame(
            image=np.full((2, 2), k), timestamp=0.05 * k,
            acc=np.ones((2, 3)) * k, gyr=np.zeros((2, 3)),
            dts=np.full(2, 0.01)))
    fr = fc.get_frame(max_skip=2)
    # Newest image, all three frames' IMU chunks.
    assert fr.image[0, 0] == 2
    assert len(fr.dts) == 6


def test_skipping_strategy_by_status():
    st = live.FrameSkippingStrategy()
    assert st.get_max_skip_frames(5) == 0          # visual init
    st.publish_system_status(live.VISUAL_INERTIAL)
    assert st.get_max_skip_frames(5) == 2
    assert st.get_max_skip_frames(1) == 0          # no backlog


def test_dataset_saver_roundtrip(tmp_path):
    from dmvio_tpu_torch.io import dataset as ds

    sv = live.DatasetSaver(str(tmp_path))
    sv.add_image(np.full((8, 8), 128.0), 0.0)
    sv.add_image(np.full((8, 8), 64.0), 0.05)
    sv.add_imu(0.02, [0.1, 0.2, 0.3], [1.0, 2.0, 9.8])
    sv.end()
    with open(tmp_path / "camera.txt", "w") as f:
        f.write("Pinhole 10 10 3.5 3.5 0\n8 8\n10 10 3.5 3.5 0\n8 8\n")
    rd = ds.open_dataset(str(tmp_path / "images"),
                         str(tmp_path / "camera.txt"),
                         ts_file=str(tmp_path / "times.txt"),
                         imu_file=str(tmp_path / "imu.txt"), device="cpu")
    assert len(rd) == 2
    assert rd.imu is not None and rd.imu.shape == (1, 7)
    assert float(rd.get_image(0)[3, 3]) == 128.0


def test_prewarm_smoke(tmp_path, monkeypatch):
    """run_dataset's prewarm=1 seam: the throwaway warm pass runs an
    init-to-steady-state cycle at the given shapes and config, caches its
    sequence in the port's own cache directory, and a second pass reads
    it back (tiny shapes keep it cheap)."""
    from dmvio_tpu_torch.run_dataset import _prewarm

    monkeypatch.setenv("DMVIO_TORCH_PREWARM_CACHE", str(tmp_path))
    cfg = window.Config(f_max=4, p_max=128, i_max=128, max_frames=3,
                        levels=3, ba_iters=2)
    _prewarm(cfg, 96, 128, None, quiet=True, n=16, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == ["seq_96x128_n16_s2.npz"]
    _prewarm(cfg, 96, 128, None, quiet=True, n=16, device="cpu")


def test_cli_framelog_and_native_loader_notice(tmp_path, monkeypatch,
                                               capsys):
    """DMVIO_FRAMELOG=path writes one line per frame after its header;
    when nativeLoader=1 cannot start (a zipped dataset) the CLI says so on
    stderr and reads with the Python loader."""
    import zipfile

    from dmvio_tpu_torch import run_dataset

    data = tmp_path / "data"
    _tiny_dataset(str(data))
    with zipfile.ZipFile(data / "images.zip", "w") as z:
        for p in sorted((data / "images").iterdir()):
            z.write(p, p.name)
    monkeypatch.setenv("DMVIO_FRAMELOG", str(tmp_path / "frames.log"))
    summary = run_dataset.run([
        f"files={data}/images.zip", f"calib={data}/camera.txt",
        f"tsFile={data}/times.txt", f"resultsPrefix={tmp_path}/o_",
        "quiet=1", "nativeLoader=1", "levels=4", "device=cpu"])
    assert summary["native_loader"] is False and summary["frames"] == 2
    assert "native prefetch pipeline not started" in capsys.readouterr().err
    lines = (tmp_path / "frames.log").read_text().splitlines()
    assert lines[0].startswith("# fid ts kf") and len(lines) == 3
    assert [int(ln.split()[0]) for ln in lines[1:]] == [0, 1]
