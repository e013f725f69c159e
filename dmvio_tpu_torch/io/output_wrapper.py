"""Observer interface for poses, keyframes, depth maps and system status.

Copy of dmvio_tpu/io/output_wrapper.py (NumPy only). Equivalent of
DM-VIO's Output3DWrapper
(src/dso/IOWrapper/Output3DWrapper.h:144-246): consumers (viewers, loggers,
frame-skipping strategies, evaluation sinks) subscribe to pipeline events.
The FullSystem publishes through a list of these — the same observer-chain
pattern the reference uses — with numpy payloads so consumers never touch
device state.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# SystemStatus (Output3DWrapper.h:46)
VISUAL_INIT, VISUAL_ONLY, VISUAL_INERTIAL, RESETTING = 0, 1, 2, 3


class Output3DWrapper:
    """Base observer: override any subset of the callbacks."""

    def publish_cam_pose(self, frame_id: int, timestamp: float,
                         R_cw: np.ndarray, t_cw: np.ndarray) -> None:
        """Tracked pose of every frame (publishCamPose)."""

    def publish_keyframes(self, kf_poses: Dict[int, tuple]) -> None:
        """Current window keyframe poses after BA (publishKeyframes)."""

    def publish_graph(self, connectivity: Dict[int, List[int]]) -> None:
        """Keyframe co-observation connectivity (publishGraph)."""

    def push_live_frame(self, image: np.ndarray) -> None:
        """The raw tracked frame (pushLiveFrame)."""

    def push_depth_image(self, frame_id: int, u: np.ndarray, v: np.ndarray,
                         idepth: np.ndarray, img=None) -> None:
        """Sparse inverse-depth map of the newest KF (pushDepthImage);
        `img` is the KF's level-0 image when available. Only published
        when a subscribed wrapper sets wants_depth_images (saves one
        device fetch per keyframe otherwise)."""

    def publish_system_status(self, status: int) -> None:
        """VISUAL_INIT / VISUAL_ONLY / VISUAL_INERTIAL / RESETTING
        (publishSystemStatus)."""

    def publish_frame_energy_th(self, frame_id: int, th: float) -> None:
        """Adaptive photometric outlier threshold of the newest keyframe
        (setNewFrameEnergyTH, FullSystemOptimize.cpp:96-147)."""

    def publish_transform_dso_to_imu(self, s: float,
                                     g2: np.ndarray) -> None:
        """Current metric transform (publishTransformDSOToIMU)."""

    def publish_imu_state(self, timestamp: float, scale: float,
                          bias_gyro: np.ndarray, bias_acc: np.ndarray,
                          velocity: np.ndarray,
                          gravity_dir: np.ndarray) -> None:
        """Newest keyframe's inertial estimates after BA. Only published
        when a subscribed wrapper sets wants_imu_state (saves one device
        fetch per keyframe otherwise)."""

    def join(self) -> None:
        """Block until the consumer finished (join)."""

    def reset(self) -> None:
        """System reset notification."""


class TrajectoryLogger(Output3DWrapper):
    """Sample consumer: records every published pose (SampleOutputWrapper
    parity) — useful in tests and as a template."""

    def __init__(self):
        self.poses = []
        self.statuses = []
        self.transforms = []

    def publish_cam_pose(self, frame_id, timestamp, R_cw, t_cw):
        self.poses.append((frame_id, timestamp, R_cw, t_cw))

    def publish_system_status(self, status):
        self.statuses.append(status)

    def publish_transform_dso_to_imu(self, s, g2):
        self.transforms.append((s, np.asarray(g2)))


class StateStreamWriter(Output3DWrapper):
    """Per-keyframe inertial estimate streams under the reference's file
    names (BAIMULogic.cpp:88-91): <prefix>scalesdso.txt (timestamp scale),
    <prefix>babiasdso.txt (timestamp gyro-bias[3] acc-bias[3]),
    <prefix>bagravdir.txt (timestamp gravity-direction[3]),
    <prefix>bavel.txt (timestamp velocity[3])."""

    wants_imu_state = True

    def __init__(self, prefix: str):
        self._scale = open(prefix + "scalesdso.txt", "w")
        self._bias = open(prefix + "babiasdso.txt", "w")
        self._grav = open(prefix + "bagravdir.txt", "w")
        self._vel = open(prefix + "bavel.txt", "w")
        # Adaptive per-keyframe energy threshold (setNewFrameEnergyTH,
        # FullSystemOptimize.cpp:96-147) — ours, the reference only logs
        # it to stdout under debug.
        self._energyth = open(prefix + "energyth.txt", "w")

    def publish_frame_energy_th(self, frame_id, th):
        self._energyth.write(f"{int(frame_id)} {float(th):.8g}\n")
        self._energyth.flush()

    def publish_imu_state(self, timestamp, scale, bias_gyro, bias_acc,
                          velocity, gravity_dir):
        v3 = lambda a: " ".join(f"{float(x):.8g}" for x in np.asarray(a))
        self._scale.write(f"{timestamp:.6f} {scale:.12g}\n")
        self._bias.write(f"{timestamp:.6f} {v3(bias_gyro)} {v3(bias_acc)}\n")
        self._grav.write(f"{timestamp:.6f} {v3(gravity_dir)}\n")
        self._vel.write(f"{timestamp:.6f} {v3(velocity)}\n")
        for f in (self._scale, self._bias, self._grav, self._vel):
            f.flush()    # live-readable streams, one flush per keyframe

    def join(self):
        for f in (self._scale, self._bias, self._grav, self._vel):
            f.flush()
            f.close()
