"""Live-mode CLI: run odometry on a streaming camera + IMU source.

Counterpart of dmvio_tpu/run_live.py, the equivalent of DM-VIO's
dmvio_t265 main (src/main_dmvio_t265.cpp:97-305): a capture thread feeds
images/IMU into an IMUInterpolator -> FrameContainer pipeline; the main
loop pops frames with adaptive skipping (FrameSkippingStrategy) and feeds
the FullSystem; an optional DatasetSaver records the stream to disk in
dataset format.

There is no camera driver here, so the source is pluggable: pass
`source=folder:<dataset-dir>` to replay a recorded dataset through the
LIVE pipeline (capture thread + queue + skipping: the same code path a
real sensor callback would drive), or wire a custom source via
`run_with_source`. `device=` (default cuda) picks the card; without CUDA
the run raises unless device=cpu is passed.

Usage:
    python -m dmvio_tpu_torch.run_live source=folder:/path/to/ds \
        calib=camera.txt [imuFile=imu.txt tsFile=times.txt useimu=1 ...]
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np


def run_with_source(feed_fn, fs, container, skipper, saver=None,
                    quiet=False):
    """Drive a FullSystem from a FrameContainer fed by `feed_fn(interp)`.

    feed_fn runs on a capture thread and pushes into the interpolator
    (add_acc_data/add_gyr_data/add_image) until the stream ends."""
    from dmvio_tpu_torch.io import live

    interp = live.IMUInterpolator(container)
    done = threading.Event()

    def capture():
        try:
            feed_fn(interp)
        finally:
            done.set()

    th = threading.Thread(target=capture, daemon=True)
    th.start()

    n = 0
    while not (done.is_set() and container.qsize() == 0):
        max_skip = skipper.get_max_skip_frames(container.qsize())
        fr = container.get_frame(max_skip=max_skip, timeout=0.5)
        if fr is None:
            continue
        imu_chunk = None
        if len(fr.dts):
            imu_chunk = (fr.acc, fr.gyr, fr.dts)
        if saver is not None:
            saver.add_image(fr.image, fr.timestamp)
        fs.add_frame(fr.image, fr.timestamp, imu_data=imu_chunk)
        n += 1
        if not quiet and n % 50 == 0:
            print(f"live frame {n} kf={fs.stats_kf} init={fs.initialized} "
                  f"queue={container.qsize()}")
    th.join(timeout=1.0)
    fs.finish()
    return n


def run(argv=None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    import dmvio_tpu_torch
    from dmvio_tpu_torch.io import dataset as ds
    from dmvio_tpu_torch.io import live
    from dmvio_tpu_torch.models import full_system, window
    from dmvio_tpu_torch.utils import trajectory
    from dmvio_tpu_torch.utils.settings import SettingsUtil

    su = SettingsUtil()
    for name, default in [
        ("source", ""), ("calib", ""), ("gammaCalib", ""), ("vignette", ""),
        ("imuFile", ""), ("tsFile", ""), ("camchain", ""),
        ("resultsPrefix", "./"), ("useimu", 0), ("quiet", 0),
        ("saveDatasetDir", ""), ("maxFrames", -1), ("speed", 0.0),
        ("device", "cuda"),
    ]:
        su.register(name, default)
    cfg = window.Config()
    su.register_from(cfg, prefix="")
    for a in argv:
        su.parse_arg(a)
    su.apply_to(cfg, only_overridden=True)
    dev = dmvio_tpu_torch.device(su["device"])

    src = su["source"]
    if not src.startswith("folder:"):
        raise SystemExit(
            "no live sensor backend in this build; use "
            "source=folder:<dataset-dir> to replay through the live "
            "pipeline, or call run_with_source() with a custom feed")
    folder = src.split(":", 1)[1]
    reader = ds.open_dataset(
        folder + "/images", su["calib"],
        gamma=su["gammaCalib"] or None, vignette=su["vignette"] or None,
        imu_file=su["imuFile"] or None, ts_file=su["tsFile"] or None,
        device=dev)
    h, w = reader.undist.out_size[1], reader.undist.out_size[0]

    imu_calib = None
    if su["useimu"] and reader.imu is not None:
        from dmvio_tpu_torch.models.imu_system import IMUCalib

        imu_calib = IMUCalib()
    fs = full_system.FullSystem(reader.undist.K_out, h, w, cfg, device=dev,
                                imu_calib=imu_calib)
    container = live.FrameContainer()
    skipper = live.FrameSkippingStrategy()
    fs.output_wrappers.append(skipper)
    saver = (live.DatasetSaver(su["saveDatasetDir"])
             if su["saveDatasetDir"] else None)

    n_max = len(reader) if su["maxFrames"] <= 0 else min(
        len(reader), su["maxFrames"])
    speed = float(su["speed"])

    def feed(interp):
        # Replay the dataset through the live path: raw IMU samples go to
        # the interpolator exactly as a sensor callback would deliver them,
        # and images as host arrays, as a camera driver delivers them.
        t_prev = None
        for i in range(n_max):
            fr = reader.frames[i]
            if reader.imu is not None:
                acc, gyr, dts = reader.get_imu_chunk(i)
                t = fr.timestamp - float(np.sum(dts))
                for k in range(len(dts)):
                    t += float(dts[k])
                    interp.add_gyr_data(gyr[k], t)
                    interp.add_acc_data(acc[k], t)
            img = reader.get_image(i)
            interp.add_image(img.cpu().numpy(), fr.timestamp)
            if speed > 0 and t_prev is not None:
                time.sleep(max(0.0, (fr.timestamp - t_prev) / speed))
            t_prev = fr.timestamp

    n = run_with_source(feed, fs, container, skipper, saver,
                        quiet=bool(su["quiet"]))
    if saver is not None:
        saver.end()

    prefix = su["resultsPrefix"]
    trajectory.write_tum(prefix + "result.txt", fs.trajectory())
    summary = {"frames": n, "keyframes": fs.stats_kf,
               "initialized": fs.initialized,
               "result": prefix + "result.txt"}
    if not su["quiet"]:
        print(f"live run: {n} frames, {fs.stats_kf} keyframes")
    return summary


if __name__ == "__main__":
    run()
