"""The port's `render_traj` and `viewer` CLIs, on the CPU, on a tiny run the
port saves here (3 frames of the synthetic room at the reader's 160x120,
the object layer on).

- `render_traj` as a subprocess (`--device cpu`, `--with-instance`): its
  RGB, depth and instance PNGs, read back with `read_png`, equal to the
  in-process `render_state` / `render_instance` of the saved map at the
  same poses, byte for byte (one torch thread in both processes).
- `ViewerState.render` against the JAX package's on one map carried
  across with `convert.py`, at 64x48, in colour, depth and colour with the
  object and frustum overlays: 8-bit images of renders that agree to
  1e-5, so at most one level apart, at under 1% of the pixels.
- The HTTP routes on a free port, the server in a thread: `/` the page,
  `/stats` the live Gaussians, `/render` a PNG equal to the view's render
  (the JAX viewer sends JPEG; the port sends PNG, without PIL).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 3
RUN = dict(frame_num=FRAMES, capacity=16384, add_capacity=4096,
           uniform_sample_num=1500, gaussian_update_frame=2,
           gaussian_update_iter=2, final_global_iter=1,
           stable_confidence_thres=2)


@pytest.fixture(scope="module")
def saved_run(tmp_path_factory):
    """A port run of `configs/synthetic/room.yaml` cut to 3 frames and
    small settings: (the config's path, the run's directory)."""
    from dqo_map_tpu_torch.config import Config
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    d = tmp_path_factory.mktemp("viewer_run")
    cfg_path = d / "config.yaml"
    lines = [f"parent: {os.path.join(REPO, 'configs', 'synthetic', 'room.yaml')}",
             f"save_path: {d / 'run'}"] + [f"{k}: {v}" for k, v in RUN.items()]
    cfg_path.write_text("\n".join(lines) + "\n")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = SLAMSystem(Config.from_yaml(str(cfg_path)), device="cpu")
        system.run(verbose=False)
    finally:
        torch.set_num_threads(n)
    assert system.object_layer.objects        # the overlays have objects
    return str(cfg_path), str(d / "run")


def _saved(run_dir):
    from dqo_map_tpu_torch.cli.metric import find_model
    return find_model(run_dir), os.path.join(run_dir, "save_traj",
                                             "pose_es.npy")


def test_render_traj_cli_matches_render_state(saved_run, tmp_path):
    from dqo_map_tpu_torch.config import Config
    from dqo_map_tpu_torch.data import Dataset
    from dqo_map_tpu_torch.models.cameras import Camera
    from dqo_map_tpu_torch.slam.renderer import (Renderer, render_instance,
                                                 render_state)
    from dqo_map_tpu_torch.utils.ply import load_map_ply
    cfg_path, run_dir = saved_run
    model, traj = _saved(run_dir)
    out = tmp_path / "flythrough"
    res = subprocess.run(
        [sys.executable, "-m", "dqo_map_tpu_torch.cli.render_traj",
         "--config", cfg_path, "--model", model, "--traj", traj, "--out",
         str(out), "--frame-step", "2", "--with-instance", "--device", "cpu",
         "--capacity", "16384"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    names = sorted(os.listdir(out))
    assert names == [f"{k}_{i:05d}.png" for k in ("depth", "instance", "rgb")
                     for i in (0, 2)]

    cfg = Config.from_yaml(cfg_path)
    cam0 = Dataset(cfg.dataset).cameras[0]
    settings = Renderer(cfg.map, cam0.width, cam0.height).settings
    state = load_map_ply(model, 16384, device="cpu")
    poses = np.load(traj)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in (0, 2):
            cam = Camera(uid=i, c2w=poses[i], fx=cam0.fx, fy=cam0.fy,
                         cx=cam0.cx, cy=cam0.cy, width=cam0.width,
                         height=cam0.height)
            ci = cam.render_inputs("cpu")
            with torch.no_grad():
                r = render_state(state, ci, settings, "global")
                want = {"rgb": r["render"],
                        "depth": r["depth"] / float(cfg.map.max_depth),
                        "instance": render_instance(state, ci, settings)}
            for k, v in want.items():
                img = np.clip(v.numpy() * 255, 0, 255).astype(np.uint8)
                got = read_png(str(out / f"{k}_{i:05d}.png"))
                assert got.shape == img.shape and np.array_equal(got, img), k
    finally:
        torch.set_num_threads(n)
    assert read_png(str(out / "rgb_00000.png")).shape == (cam0.height,
                                                          cam0.width, 3)


@pytest.fixture(scope="module")
def views(saved_run):
    """The port's and the JAX package's `ViewerState` at 64x48 on the saved
    map (the JAX one carried across with `convert.py`), with the run's
    objects and frusta."""
    import jax.numpy as jnp

    from dqo_map_tpu.cli.viewer import ViewerState as JViewerState
    from dqo_map_tpu.config import Config as JConfig
    from dqo_map_tpu.models.gaussian_map import MapState as JMapState
    from dqo_map_tpu_torch.cli.viewer import load_view
    from dqo_map_tpu_torch.config import Config
    from dqo_map_tpu_torch.convert import map_state_to_numpy
    cfg_path, run_dir = saved_run
    view = load_view(Config.from_yaml(cfg_path), run_dir, 64, 48, 16384,
                     "cpu")
    jstate = JMapState(**{k: jnp.asarray(v) for k, v in
                          map_state_to_numpy(view.state).items()})
    jview = JViewerState(JConfig.from_yaml(cfg_path), jstate, 64, 48,
                         view.init_pose)
    jview.objects, jview.frusta = view.objects, view.frusta
    assert view.objects and view.frusta
    return view, jview


@pytest.mark.parametrize("mode", ["color", "depth", "color+obj"])
def test_viewer_render_matches_jax(views, mode):
    view, jview = views
    for yaw, pitch, offset in ((0.0, 0.0, [0, 0, 0]),
                               (0.3, -0.2, [0.1, 0.0, -0.3])):
        got = view.render(yaw, pitch, offset, mode)
        ref = jview.render(yaw, pitch, offset, mode)
        assert got.shape == ref.shape == (48, 64, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (mode, yaw)
        assert got.std() > 0                      # the view shows the room


def _get(url):
    # straight to the local server, never through a proxy
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=120) as r:
        return r.headers["Content-Type"], r.read()


def test_viewer_http_routes(views, tmp_path):
    from dqo_map_tpu_torch.cli.viewer import make_server
    view, _ = views
    srv = make_server(view, 0, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        kind, page = _get(base + "/")
        assert kind == "text/html" and b'width="64" height="48"' in page
        kind, body = _get(base + "/stats")
        stats = json.loads(body)
        assert kind == "application/json"
        assert stats == {"n_gaussians": int((view.state.status != 0).sum()),
                         "frame": -1} and stats["n_gaussians"] > 0
        for query, args in (("yaw=0.3&pitch=-0.2&x=0.1&y=0&z=-0.3&mode=color%2Bobj",
                             (0.3, -0.2, [0.1, 0.0, -0.3], "color+obj")),
                            ("mode=depth", (0.0, 0.0, [0.0, 0.0, 0.0], "depth"))):
            kind, png = _get(f"{base}/render?{query}")
            assert kind == "image/png"
            (tmp_path / "view.png").write_bytes(png)
            assert np.array_equal(read_png(str(tmp_path / "view.png")),
                                  view.render(*args))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
