"""Headless visualization consumer: depth overlays, trajectory plot, HTML
report.

Copy of dmvio_tpu/io/viewer.py (NumPy only), the counterpart of DM-VIO's
Pangolin viewer
(src/dso/IOWrapper/Pangolin/PangolinDSOViewer.cpp, KeyFrameDisplay.cpp):
instead of an interactive GL window (a GUI dependency the reference itself
stubs out with dummy wrappers when Pangolin is absent), this renders the
same content — keyframe inverse-depth maps, the camera trajectory, keyframe
frusta positions, system status — into PNG/HTML artifacts. It subscribes
through the Output3DWrapper observer chain like any other consumer.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from dmvio_tpu_torch.io import image_rw
from dmvio_tpu_torch.io.output_wrapper import Output3DWrapper

_STATUS_NAMES = {0: "VISUAL_INIT", 1: "VISUAL_ONLY", 2: "VISUAL_INERTIAL",
                 3: "RESETTING"}


class HeadlessViewer(Output3DWrapper):
    """Renders pipeline events into an artifact directory.

    wants_depth_images makes FullSystem fetch + publish the sparse
    inverse-depth map of each new keyframe (one extra device fetch per
    KF, skipped entirely when no attached wrapper asks for it).
    """

    wants_depth_images = True

    def __init__(self, out_dir: str, depth_every: int = 1,
                 max_depth_images: int = 200):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.depth_every = max(1, depth_every)
        self.max_depth_images = max_depth_images
        self.poses = []                       # (fid, ts, R_cw, t_cw)
        self.kf_poses: Dict[int, tuple] = {}
        self.statuses = []                    # (n_poses_so_far, status)
        self.scale = None
        self._n_kf_published = 0
        self._depth_files = []
        self._resets = 0

    # -- observer events ---------------------------------------------------
    def publish_cam_pose(self, frame_id, timestamp, R_cw, t_cw):
        self.poses.append((frame_id, timestamp,
                           np.asarray(R_cw).copy(), np.asarray(t_cw).copy()))

    def publish_keyframes(self, kf_poses):
        for fid, (R, t) in kf_poses.items():
            self.kf_poses[fid] = (np.asarray(R).copy(), np.asarray(t).copy())

    def publish_system_status(self, status):
        self.statuses.append((len(self.poses), status))

    def publish_transform_dso_to_imu(self, s, g2):
        self.scale = float(s)

    def reset(self):
        self._resets += 1

    def push_depth_image(self, frame_id, u, v, idepth, img=None):
        """Render the newest KF's sparse inverse-depth overlay
        (KeyFrameDisplay semantics: points colored by idepth)."""
        self._n_kf_published += 1
        if (self._n_kf_published - 1) % self.depth_every != 0:
            return
        if len(self._depth_files) >= self.max_depth_images:
            return
        u = np.asarray(u)
        v = np.asarray(v)
        d = np.asarray(idepth, np.float32)
        ok = np.isfinite(d) & (d > 0)
        if img is not None:
            base = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
            canvas = np.stack([base] * 3, axis=-1)
            h, w = base.shape
        else:
            h = int(v[ok].max()) + 8 if ok.any() else 480
            w = int(u[ok].max()) + 8 if ok.any() else 640
            canvas = np.zeros((h, w, 3), np.uint8)
        if ok.any():
            dmid = np.median(d[ok])
            rel = np.clip(d / max(dmid, 1e-6) * 0.5, 0.0, 1.0)
            colors = image_rw.colormap_jet(rel)
            ui = np.clip(u.astype(np.int32), 1, w - 2)
            vi = np.clip(v.astype(np.int32), 1, h - 2)
            for du in (-1, 0, 1):
                for dv in (-1, 0, 1):
                    canvas[vi[ok] + dv, ui[ok] + du] = colors[ok]
        name = f"depth_kf{frame_id:06d}.png"
        image_rw.write_png(os.path.join(self.out_dir, name), canvas)
        self._depth_files.append(name)

    def push_live_frame(self, image):
        pass  # live frames are covered by the depth overlays

    # -- report ------------------------------------------------------------
    def _render_trajectory(self, size: int = 800) -> Optional[str]:
        """Top-down (x, z lateral / forward) trajectory + KF frusta plot."""
        if len(self.poses) < 2:
            return None
        centers = []
        for _, _, R, t in self.poses:
            centers.append(-R.T @ t)        # camera center in world
        P = np.asarray(centers)
        kf = np.asarray([-R.T @ t for R, t in self.kf_poses.values()]) \
            if self.kf_poses else np.zeros((0, 3))
        # Use the two highest-variance axes as the plot plane.
        var = P.var(axis=0)
        ax0, ax1 = np.argsort(var)[-2:]
        lo = P[:, [ax0, ax1]].min(axis=0)
        hi = P[:, [ax0, ax1]].max(axis=0)
        span = max((hi - lo).max(), 1e-6)
        pad = 0.08 * span

        def to_px(xy):
            q = (xy - lo + pad) / (span + 2 * pad) * (size - 1)
            return np.clip(q, 0, size - 1).astype(np.int32)

        canvas = np.full((size, size, 3), 24, np.uint8)
        pts = to_px(P[:, [ax0, ax1]])
        # Line rasterization between consecutive frame positions.
        for k in range(len(pts) - 1):
            x0, y0 = pts[k]
            x1, y1 = pts[k + 1]
            n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
            xs = np.linspace(x0, x1, n + 1).astype(np.int32)
            ys = np.linspace(y0, y1, n + 1).astype(np.int32)
            canvas[size - 1 - ys, xs] = (90, 200, 90)
        if len(kf):
            kfp = to_px(kf[:, [ax0, ax1]])
            for x, y in kfp:
                y = size - 1 - y
                canvas[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = \
                    (80, 120, 255)
        name = "trajectory.png"
        image_rw.write_png(os.path.join(self.out_dir, name), canvas)
        return name

    def join(self):
        """Write the HTML report (the artifact-mode analogue of closing
        the viewer window)."""
        traj = self._render_trajectory()
        rows = []
        if traj:
            rows.append(f'<h2>Trajectory ({len(self.poses)} frames, '
                        f'{len(self.kf_poses)} keyframes)</h2>'
                        f'<img src="{traj}" width="640"/>')
        if self.scale is not None:
            rows.append(f"<p>Metric scale (DSO→IMU): {self.scale:.4f}</p>")
        if self._resets:
            rows.append(f"<p>System resets: {self._resets}</p>")
        if self.statuses:
            seq = ", ".join(
                f"frame {n}: {_STATUS_NAMES.get(s, s)}"
                for n, s in self.statuses)
            rows.append(f"<p>Status transitions: {seq}</p>")
        if self._depth_files:
            rows.append("<h2>Keyframe inverse-depth maps</h2>")
            for f in self._depth_files:
                rows.append(f'<div style="display:inline-block;margin:2px">'
                            f'<img src="{f}" width="320"/><br/>'
                            f'<small>{f}</small></div>')
        html = ("<html><body style='background:#111;color:#ddd;"
                "font-family:sans-serif'>" + "\n".join(rows)
                + "</body></html>")
        with open(os.path.join(self.out_dir, "index.html"), "w") as f:
            f.write(html)
