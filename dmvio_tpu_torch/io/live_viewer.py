"""Live HTTP viewer: the Pangolin-viewer role, for headless hosts.

Copy of dmvio_tpu/io/live_viewer.py (NumPy and the standard library).

The reference's PangolinDSOViewer is a live Output3DWrapper rendering the
trajectory, the keyframe graph and the newest keyframe's inverse-depth
map while the pipeline runs (src/dso/IOWrapper/Output3DWrapper.h:144-246,
PangolinDSOViewer.cpp). A GL window is useless on a headless host, so
this observer serves the same live content over HTTP from a background
thread instead: any browser (local or port-forwarded) shows the running
system. Zero dependencies beyond the stdlib + PIL; costs nothing on the
pipeline thread beyond copying small numpy payloads under a lock.

Endpoints:
    /            one-page viewer (canvas trajectory + depth image, polls)
    /state.json  trajectory, keyframes, status, metric scale, counters
    /depth.jpg   newest keyframe's inverse-depth overlay
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from dmvio_tpu_torch.io.output_wrapper import Output3DWrapper

_PAGE = """<!doctype html>
<html><head><title>dmvio_tpu_torch live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:16px}
canvas,img{border:1px solid #333;background:#000}
.row{display:flex;gap:16px;flex-wrap:wrap}
</style></head><body>
<h3>dmvio_tpu_torch live viewer</h3>
<div id=stat>connecting...</div>
<div class=row>
<canvas id=traj width=480 height=480></canvas>
<img id=depth width=480 src="/depth.jpg">
</div>
<script>
const cv=document.getElementById('traj'),cx=cv.getContext('2d');
async function tick(){
 try{
  const s=await (await fetch('/state.json')).json();
  document.getElementById('stat').textContent=
   `frame ${s.frame}  kfs ${s.n_kfs}  status ${s.status}  scale ${s.scale===null?'-':s.scale.toFixed(4)}`;
  const T=s.traj;cx.fillStyle='#000';cx.fillRect(0,0,480,480);
  if(T.length>1){
   let xs=T.map(p=>p[0]),ys=T.map(p=>p[1]);
   const mnx=Math.min(...xs),mxx=Math.max(...xs),mny=Math.min(...ys),mxy=Math.max(...ys);
   const sc=440/Math.max(mxx-mnx,mxy-mny,1e-6);
   const px=p=>[20+(p[0]-mnx)*sc,460-(p[1]-mny)*sc];
   cx.strokeStyle='#4af';cx.beginPath();
   T.forEach((p,i)=>{const[a,b]=px(p);i?cx.lineTo(a,b):cx.moveTo(a,b)});cx.stroke();
   cx.fillStyle='#fc3';
   s.kfs.forEach(p=>{const[a,b]=px(p);cx.fillRect(a-2,b-2,4,4)});
  }
  document.getElementById('depth').src='/depth.jpg?'+Date.now();
 }catch(e){document.getElementById('stat').textContent='disconnected';}
}
setInterval(tick,500);tick();
</script></body></html>"""


def _depth_jpeg(u, v, idepth, img, h=None, w=None) -> bytes:
    """Render the sparse inverse-depth overlay to JPEG bytes (the
    KF depth view of the reference viewer)."""
    from PIL import Image

    if img is not None:
        base = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        h, w = base.shape
        rgb = np.stack([base] * 3, axis=-1)
    else:
        h = int(h or (np.max(v) + 1 if len(v) else 8))
        w = int(w or (np.max(u) + 1 if len(u) else 8))
        rgb = np.zeros((h, w, 3), np.uint8)
    if len(u):
        d = np.asarray(idepth, np.float64)
        lo, hi = np.percentile(d, [5, 95]) if len(d) > 4 else (d.min(), d.max())
        t = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
        # Blue (far) -> red (near) ramp.
        col = np.stack([255 * t, 64 + 0 * t, 255 * (1 - t)],
                       axis=-1).astype(np.uint8)
        ui = np.clip(np.asarray(u, np.int64), 0, w - 1)
        vi = np.clip(np.asarray(v, np.int64), 0, h - 1)
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                rgb[np.clip(vi + dv, 0, h - 1),
                    np.clip(ui + du, 0, w - 1)] = col
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=85)
    return buf.getvalue()


class LiveViewer(Output3DWrapper):
    """Serve the pipeline's live state over HTTP (see module docstring).

    port=0 picks an ephemeral port; read .port after construction."""

    wants_depth_images = True

    def __init__(self, port: int = 8765, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._traj = []          # [x, y, z] per tracked frame
        self._kfs = []
        self._depth: Optional[bytes] = None
        self._status = -1
        self._scale: Optional[float] = None
        self._frame = -1

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence per-request stderr spam
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif path == "/state.json":
                    with viewer._lock:
                        body = json.dumps(dict(
                            traj=viewer._traj[-2000:],
                            kfs=viewer._kfs,
                            status=viewer._status,
                            scale=viewer._scale,
                            frame=viewer._frame,
                            n_kfs=len(viewer._kfs))).encode()
                    ctype = "application/json"
                elif path == "/depth.jpg":
                    with viewer._lock:
                        body = viewer._depth or b""
                    ctype = "image/jpeg"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # -- observer callbacks ------------------------------------------------
    def publish_cam_pose(self, frame_id, timestamp, R_cw, t_cw):
        R_cw = np.asarray(R_cw, np.float64)
        t_wc = -R_cw.T @ np.asarray(t_cw, np.float64)
        with self._lock:
            self._traj.append([float(t_wc[0]), float(t_wc[1]),
                               float(t_wc[2])])
            self._frame = int(frame_id)

    def publish_keyframes(self, kf_poses):
        kfs = []
        for fid, (R_cw, t_cw) in kf_poses.items():
            t_wc = -np.asarray(R_cw).T @ np.asarray(t_cw)
            kfs.append([float(t_wc[0]), float(t_wc[1]), float(t_wc[2])])
        with self._lock:
            self._kfs = kfs

    def push_depth_image(self, frame_id, u, v, idepth, img=None):
        jpg = _depth_jpeg(u, v, idepth, img)
        with self._lock:
            self._depth = jpg

    def publish_system_status(self, status):
        with self._lock:
            self._status = int(status)

    def publish_transform_dso_to_imu(self, s, g2):
        with self._lock:
            self._scale = float(s)

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    def join(self):
        self.close()
