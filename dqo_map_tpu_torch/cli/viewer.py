"""Interactive map viewer (counterpart of `dqo_map_tpu/cli/viewer.py`):
a zero-dependency HTTP viewer in the slot of the reference's Open3D GUI.
It serves a small HTML page (WASD/arrow + drag navigation) and renders
the requested camera poses through the same rasterizer as the SLAM loop
(the blend kernel K1 on the card), streaming PNG frames. Works against a
saved run directory (PLY and trajectory) or a live `SLAMSystem`
(`ViewerState.update` swaps the map it renders).

    python -m dqo_map_tpu_torch.cli.viewer --config <cfg> --model <run_dir> \
        [--port 8090] [--width 640] [--height 480] [--device cuda]

`make_server` builds the `ThreadingHTTPServer` (on a free port with port
0), `serve` builds it and serves forever: a caller can run the server in a
thread and shut it down.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>dqo_map_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
img{display:block;margin:0 auto;image-rendering:pixelated}
</style></head><body>
<div id="hud">drag: look &nbsp; WASD/QE: move &nbsp; 1/2: color|depth
  &nbsp; 3: ellipsoids <span id="s"></span></div>
<img id="v" width="%W%" height="%H%">
<script>
let yaw=0,pitch=0,pos=[0,0,0],mode='color',drag=null,busy=false;
const img=document.getElementById('v'),hud=document.getElementById('s');
function req(){ if(busy) return; busy=true;
 fetch(`/render?yaw=${yaw}&pitch=${pitch}&x=${pos[0]}&y=${pos[1]}&z=${pos[2]}&mode=${mode}`)
 .then(r=>r.blob()).then(b=>{img.src=URL.createObjectURL(b);busy=false;})
 .catch(()=>{busy=false;}); }
img.onmousedown=e=>{drag=[e.clientX,e.clientY];};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{if(!drag)return;
 yaw+=(e.clientX-drag[0])*0.004; pitch+=(e.clientY-drag[1])*0.004;
 drag=[e.clientX,e.clientY]; req();};
window.onkeydown=e=>{const st=0.1,
 f=[Math.sin(yaw)*Math.cos(pitch),-Math.sin(pitch),Math.cos(yaw)*Math.cos(pitch)],
 r=[Math.cos(yaw),0,-Math.sin(yaw)];
 if(e.key=='w')pos=pos.map((p,i)=>p+f[i]*st);
 if(e.key=='s')pos=pos.map((p,i)=>p-f[i]*st);
 if(e.key=='a')pos=pos.map((p,i)=>p-r[i]*st);
 if(e.key=='d')pos=pos.map((p,i)=>p+r[i]*st);
 if(e.key=='q')pos[1]-=st; if(e.key=='e')pos[1]+=st;
 if(e.key=='1')mode='color'; if(e.key=='2')mode='depth';
 if(e.key=='3')mode=(mode=='color'?'color+obj':'color');
 req();};
setInterval(()=>{fetch('/stats').then(r=>r.json()).then(j=>{
 hud.textContent=` | ${j.n_gaussians} gaussians, frame ${j.frame}`;});},2000);
req();
</script></body></html>"""


class ViewerState:
    """Holds the map snapshot and the render settings; a thread-safe swap
    (`update`). Renders on `device`."""

    def __init__(self, cfg, state, width, height, init_pose=None,
                 device="cuda"):
        from ..slam.renderer import Renderer
        self.lock = threading.Lock()
        self.state = state
        self.device = device
        self.renderer = Renderer(cfg.map, width, height)
        self.width, self.height = width, height
        self.frame_id = -1
        self.init_pose = np.eye(4) if init_pose is None else init_pose
        self.fx = 0.9 * width
        self.objects = []
        self.frusta = []

    def update(self, state, frame_id):
        with self.lock:
            self.state = state
            self.frame_id = frame_id

    def camera(self, yaw, pitch, offset):
        from ..models.cameras import Camera
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        c2w = np.array(self.init_pose, np.float64)
        c2w[:3, :3] = c2w[:3, :3] @ R_yaw @ R_pitch
        c2w[:3, 3] += c2w[:3, :3] @ np.asarray(offset)
        return Camera(uid=0, c2w=c2w, fx=self.fx, fy=self.fx,
                      cx=self.width / 2, cy=self.height / 2,
                      width=self.width, height=self.height)

    def render(self, yaw, pitch, offset, mode):
        """The (H, W, 3) uint8 view from the camera `yaw` / `pitch` /
        `offset` away from the initial pose: colour, or (`mode` "depth")
        depth over its largest value; "color+obj" draws the overlays."""
        import torch

        from ..slam.renderer import render_state
        cam = self.camera(yaw, pitch, offset)
        with self.lock:
            st = self.state
        with torch.no_grad():
            out = render_state(st, cam.render_inputs(self.device),
                               self.renderer.settings, "global")
        if mode == "depth":
            d = out["depth"].cpu().numpy()
            dmax = max(float(d.max()), 1e-6)
            img = np.repeat((d / dmax)[..., None], 3, -1)
        else:
            img = out["render"].cpu().numpy()
        img = np.clip(img * 255, 0, 255).astype(np.uint8).copy()
        if "obj" in mode:
            self.draw_overlays(img, cam)
        return img

    # ------------------------------------------------------------------
    # wireframe overlays (the reference viewer's ellipsoid checkbox and
    # frustum drawing): `objects` = [{"t": (3,), "R": (3,3), "axes": (3,)}],
    # `frusta` = [c2w (4,4)] keyframe poses, both set by `load_view`
    # ------------------------------------------------------------------
    def _project_segments(self, img, pts_w, color, w2c):
        """Draw a world-space polyline by sampled-point projection."""
        p = pts_w @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        ok = z > 0.05
        u = (p[:, 0] / np.where(ok, z, 1)) * self.fx + self.width / 2
        v = (p[:, 1] / np.where(ok, z, 1)) * self.fx + self.height / 2
        ui = np.round(u).astype(int)
        vi = np.round(v).astype(int)
        m = ok & (ui >= 0) & (ui < self.width) & (vi >= 0) & (vi < self.height)
        img[vi[m], ui[m]] = color

    def draw_overlays(self, img, cam):
        w2c = np.linalg.inv(np.asarray(cam.c2w, np.float64))
        th = np.linspace(0, 2 * np.pi, 256)
        ring = np.stack([np.cos(th), np.sin(th)], -1)
        for i, ob in enumerate(self.objects):
            R, t, ax = np.asarray(ob["R"]), np.asarray(ob["t"]), \
                np.asarray(ob["axes"])
            col = np.array([(73 * (i + 1)) % 200 + 55,
                            (131 * (i + 1)) % 200 + 55,
                            (197 * (i + 1)) % 200 + 55], np.uint8)
            for a, b in ((0, 1), (1, 2), (0, 2)):
                pts = np.zeros((len(th), 3))
                pts[:, a] = ring[:, 0] * ax[a]
                pts[:, b] = ring[:, 1] * ax[b]
                self._project_segments(img, pts @ R.T + t, col, w2c)
        for c2w in self.frusta:
            c2w = np.asarray(c2w, np.float64)
            d = 0.15
            corners = np.array([[-d, -d * 0.75, d], [d, -d * 0.75, d],
                                [d, d * 0.75, d], [-d, d * 0.75, d]])
            corners = corners @ c2w[:3, :3].T + c2w[:3, 3]
            apex = c2w[:3, 3]
            col = np.array([255, 220, 60], np.uint8)
            segs = []
            for k in range(4):
                segs.append(np.linspace(apex, corners[k], 24))
                segs.append(np.linspace(corners[k], corners[(k + 1) % 4], 24))
            self._project_segments(img, np.concatenate(segs), col, w2c)


def make_server(view: ViewerState, port: int,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The viewer's HTTP server on `host:port` (port 0: a free one, in
    `server_address`): `/` the page, `/render?yaw=&pitch=&x=&y=&z=&mode=`
    a PNG view, `/stats` the live Gaussians and the frame as JSON."""
    from ..utils.png import encode_png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, kind: str, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/render"):
                q = parse_qs(urlparse(self.path).query)
                g = lambda k, d=0.0: float(q.get(k, [d])[0])  # noqa: E731
                img = view.render(g("yaw"), g("pitch"),
                                  [g("x"), g("y"), g("z")],
                                  q.get("mode", ["color"])[0])
                self._send("image/png", encode_png(img))
            elif self.path.startswith("/stats"):
                with view.lock:
                    n = int((view.state.status != 0).sum())
                    fid = view.frame_id
                self._send("application/json",
                           json.dumps({"n_gaussians": n, "frame": fid}).encode())
            else:
                page = (_PAGE.replace("%W%", str(view.width))
                        .replace("%H%", str(view.height)))
                self._send("text/html", page.encode())

    return ThreadingHTTPServer((host, port), Handler)


def serve(view: ViewerState, port: int):
    srv = make_server(view, port)
    print(f"viewer on http://localhost:{srv.server_address[1]}/")
    srv.serve_forever()


def load_view(cfg, model_dir: str, width: int, height: int, capacity: int,
              device="cuda") -> ViewerState:
    """A `ViewerState` of a saved run: its newest PLY map, its first
    estimated pose as the initial one, the objects of
    `save_obj/objects.txt` and every twelfth of its poses as frusta."""
    from ..eval.obj_eval import load_box_file
    from ..utils.ply import load_map_ply
    from .metric import find_model
    state = load_map_ply(find_model(model_dir), capacity, device=device)
    pose_file = os.path.join(model_dir, "save_traj", "pose_es.npy")
    poses = np.load(pose_file) if os.path.exists(pose_file) else None
    view = ViewerState(cfg, state, width, height,
                       None if poses is None else poses[0], device)
    obj_file = os.path.join(model_dir, "save_obj", "objects.txt")
    if os.path.exists(obj_file):
        view.objects = [{"t": b.t, "R": b.R, "axes": b.axes}
                        for b in load_box_file(obj_file)]
    if poses is not None:
        step = max(1, len(poses) // 12)
        view.frusta = [poses[i] for i in range(0, len(poses), step)]
    return view


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", required=True, help="run dir with save_model/")
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from ..config import Config
    cfg = Config.from_yaml(args.config)
    serve(load_view(cfg, args.model, args.width, args.height, args.capacity,
                    args.device), args.port)


if __name__ == "__main__":
    main()
