"""Live-capture layer: frame queue, IMU stream alignment, frame skipping,
dataset saving.

Copy of dmvio_tpu/io/live.py (NumPy only), the counterpart of DM-VIO's
live stack (src/live/):
  * FrameContainer (FrameContainer.h:70-100): thread-safe producer/consumer
    queue of frames + their IMU chunks, with frame skipping where skipped
    frames' IMU data is concatenated into the next processed frame.
  * IMUInterpolator (IMUInterpolator.h:72-125): aligns asynchronous
    accelerometer/gyroscope streams by interpolating accelerometer samples
    onto gyroscope timestamps and synthesizing a sample at each image
    timestamp.
  * FrameSkippingStrategy (FrameSkippingStrategy.h:34-77): adapts the
    allowed queue backlog to the system status.
  * DatasetSaver (DatasetSaver.h:37-66): background thread writing the live
    input to disk in dataset format for offline replay.

A camera driver (e.g. a RealSense T265 binding — hardware-specific, out of
scope here) plugs in by calling add_acc_data / add_gyr_data /
add_image from its callbacks, exactly like the reference's
RealsenseT265.cpp:126-211 does.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from dmvio_tpu_torch.io import output_wrapper
# System status (reference Output3DWrapper.h:46).
from dmvio_tpu_torch.io.output_wrapper import (VISUAL_INIT, VISUAL_ONLY,
                                               VISUAL_INERTIAL, RESETTING)


@dataclass
class LiveFrame:
    image: np.ndarray
    timestamp: float
    acc: np.ndarray     # [N, 3]
    gyr: np.ndarray     # [N, 3]
    dts: np.ndarray     # [N]


class FrameContainer:
    """Thread-safe frame queue with IMU-preserving frame skipping."""

    def __init__(self, maxsize: int = 64):
        self._q: "queue.Queue[LiveFrame]" = queue.Queue(maxsize)
        self._lock = threading.Lock()

    def qsize(self) -> int:
        return self._q.qsize()

    def add_frame(self, frame: LiveFrame) -> None:
        try:
            self._q.put_nowait(frame)
        except queue.Full:
            # Drop the oldest (its IMU data is folded into the next).
            with self._lock:
                try:
                    dropped = self._q.get_nowait()
                except queue.Empty:
                    dropped = None
                if dropped is not None:
                    frame = _merge_imu(dropped, frame)
                self._q.put_nowait(frame)

    def get_frame(self, max_skip: int = 0,
                  timeout: Optional[float] = None) -> Optional[LiveFrame]:
        """Pop one frame; skip up to max_skip backlog frames, concatenating
        their IMU chunks into the returned frame (getImageAndIMUData,
        FrameContainer.h:83)."""
        try:
            frame = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        skipped = 0
        while skipped < max_skip and self._q.qsize() > 0:
            nxt = self._q.get_nowait()
            frame = _merge_imu(frame, nxt)
            skipped += 1
        return frame


def _merge_imu(old: LiveFrame, new: LiveFrame) -> LiveFrame:
    return LiveFrame(
        image=new.image, timestamp=new.timestamp,
        acc=np.concatenate([old.acc, new.acc]) if len(old.acc) else new.acc,
        gyr=np.concatenate([old.gyr, new.gyr]) if len(old.gyr) else new.gyr,
        dts=np.concatenate([old.dts, new.dts]) if len(old.dts) else new.dts,
    )


class IMUInterpolator:
    """Aligns async accel/gyro streams and packages per-frame chunks.

    Accelerometer samples are linearly interpolated onto gyroscope
    timestamps; an interpolated sample is synthesized at each image
    timestamp so chunks end exactly at frames (IMUInterpolator.h:72-125).
    Out-of-order arrivals within a small window are tolerated via sorting
    at drain time.
    """

    def __init__(self, container: FrameContainer):
        self.container = container
        self._acc: List[Tuple[float, np.ndarray]] = []
        self._gyr: List[Tuple[float, np.ndarray]] = []
        self._last_frame_ts: Optional[float] = None
        self._lock = threading.Lock()

    def add_acc_data(self, acc, timestamp: float) -> None:
        with self._lock:
            self._acc.append((timestamp, np.asarray(acc, np.float64)))

    def add_gyr_data(self, gyr, timestamp: float) -> None:
        with self._lock:
            self._gyr.append((timestamp, np.asarray(gyr, np.float64)))

    def _interp_acc(self, t: float) -> Optional[np.ndarray]:
        acc = self._acc
        if not acc:
            return None
        if t <= acc[0][0]:
            return acc[0][1]
        for k in range(1, len(acc)):
            if acc[k][0] >= t:
                t0, a0 = acc[k - 1]
                t1, a1 = acc[k]
                w = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
                return a0 * (1 - w) + a1 * w
        return acc[-1][1]

    def add_image(self, image, timestamp: float) -> None:
        """Package all samples in (last_frame_ts, timestamp] as the frame's
        chunk and enqueue."""
        with self._lock:
            self._acc.sort(key=lambda s: s[0])
            self._gyr.sort(key=lambda s: s[0])
            t0 = self._last_frame_ts
            gyr_sel = [(t, g) for (t, g) in self._gyr
                       if (t0 is None or t > t0) and t <= timestamp]
            samples = []
            prev = t0 if t0 is not None else (
                gyr_sel[0][0] - 0.005 if gyr_sel else timestamp)
            for (t, g) in gyr_sel:
                a = self._interp_acc(t)
                if a is not None:
                    samples.append((t - prev, g, a))
                    prev = t
            # Synthesized sample exactly at the image timestamp.
            if prev < timestamp and self._gyr:
                g_last = gyr_sel[-1][1] if gyr_sel else self._gyr[-1][1]
                a = self._interp_acc(timestamp)
                if a is not None:
                    samples.append((timestamp - prev, g_last, a))
            # Drop consumed samples (keep one for interpolation overlap).
            self._gyr = [(t, g) for (t, g) in self._gyr if t > timestamp]
            self._acc = [(t, a) for (t, a) in self._acc
                         if t > timestamp - 0.1]
            self._last_frame_ts = timestamp

        dts = np.array([s[0] for s in samples], np.float32)
        gyr = np.array([s[1] for s in samples], np.float32).reshape(-1, 3)
        acc = np.array([s[2] for s in samples], np.float32).reshape(-1, 3)
        self.container.add_frame(LiveFrame(
            image=np.asarray(image) if image is not None else None,
            timestamp=timestamp, acc=acc, gyr=gyr, dts=dts))


class FrameSkippingStrategy(output_wrapper.Output3DWrapper):
    """Max allowed skip per system status (FrameSkippingStrategy.h:34-77):
    none during visual init, 1 visual-only, 2 during VIO, unlimited while
    resetting. An Output3DWrapper, like the reference's: it learns the
    system status through the observer chain."""

    def __init__(self, maxskip_visual_init=0, maxskip_visual_only=1,
                 maxskip_vio=2, maxskip_reset=10000):
        self.by_status = {
            VISUAL_INIT: maxskip_visual_init,
            VISUAL_ONLY: maxskip_visual_only,
            VISUAL_INERTIAL: maxskip_vio,
            RESETTING: maxskip_reset,
        }
        self.status = VISUAL_INIT

    def publish_system_status(self, status: int) -> None:
        self.status = status

    def get_max_skip_frames(self, queue_size: int) -> int:
        # Only skip when a backlog exists (reference skips based on queue
        # pressure).
        if queue_size <= 1:
            return 0
        return self.by_status.get(self.status, 0)


class DatasetSaver:
    """Background writer of live input in the dataset format our reader
    consumes (DatasetSaver.h:37-66)."""

    def __init__(self, out_dir: str):
        self.out = out_dir
        os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._imu_rows: List[str] = []
        self._times_rows: List[str] = []
        self._n = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add_image(self, image: np.ndarray, timestamp: float) -> None:
        self._q.put(("img", image, timestamp))

    def add_imu(self, timestamp: float, gyr, acc) -> None:
        g, a = np.asarray(gyr), np.asarray(acc)
        self._imu_rows.append(
            f"{timestamp:.6f} {g[0]:.9f} {g[1]:.9f} {g[2]:.9f} "
            f"{a[0]:.9f} {a[1]:.9f} {a[2]:.9f}")

    def _run(self):
        from dmvio_tpu_torch.io import image_rw

        while not self._stop.is_set() or not self._q.empty():
            try:
                kind, img, ts = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            name = f"{self._n:05d}"
            self._n += 1
            arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
            image_rw.write_png(
                os.path.join(self.out, "images", name + ".png"), arr)
            self._times_rows.append(f"{name} {ts:.6f} 1.0")

    def end(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        with open(os.path.join(self.out, "times.txt"), "w") as f:
            f.write("\n".join(self._times_rows) + "\n")
        with open(os.path.join(self.out, "imu.txt"), "w") as f:
            f.write("\n".join(self._imu_rows) + "\n")
