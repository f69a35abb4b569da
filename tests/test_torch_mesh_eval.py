"""The port's TSDF fusion (`ops/tsdf.py`), marching tetrahedra
(`ops/marching.py`), object evaluation (`eval/obj_eval.py`) and the
`make_mesh`, `metric_obj` and `ablate_assoc` CLIs against the JAX
package, on the CPU.

Tolerances, and why:
- `integrate` and `fuse_frames` are the same float32 operations in the
  same order (the projection written out row by row, `torch.round` and
  `jnp.round` both half to even): tsdf and colour to 1e-5, weight and the
  volume's bounds exactly;
- `marching_tetrahedra`, `write_mesh_ply` and `sample_mesh_points` are a
  numpy copy: exactly;
- the box metrics are numpy / scipy on both sides: to 1e-6;
- `per_object_mesh_eval` renders each object through each package's
  plain blend (1e-5 apart), so the fused volumes and meshes can differ at
  a voxel; its metrics on a sphere of Gaussians to 2e-3 cm and 2e-3 in
  the ratios, and both packages near the sphere (accuracy under 2 cm
  with 2 cm voxels, precision at 2 cm above 0.7; the cameras see the
  front half, so completion is not bounded);
- the CLIs as subprocesses on a 4-frame run of the port at 64x48: exit 0
  and the files and numbers each promises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dqo_map_tpu.data.synthetic import synthetic_sequence as jsequence
from dqo_map_tpu.eval import obj_eval as jobj
from dqo_map_tpu.ops import marching as jmarch
from dqo_map_tpu.ops import tsdf as jtsdf
from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
from dqo_map_tpu_torch.eval import obj_eval
from dqo_map_tpu_torch.ops import marching, tsdf
from dqo_map_tpu_torch.utils.ply import (read_gaussian_ply, read_mesh_ply,
                                         write_point_normal_ply)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module, as `test_torch_run.py` does:
    its runs are many small operations, and beside the other test workers
    the thread pools' waits cost several times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    _, jc = jsequence(3, width=W, height=H)
    _, pc = synthetic_sequence(3, width=W, height=H)
    return jc, pc


def test_integrate_matches_jax(frames):
    jc, pc = frames
    origin, dims, voxel = (-2.1, -1.6, -2.1), (44, 34, 44), 0.1
    jv = jtsdf.make_volume(origin, dims, voxel)
    pv = tsdf.make_volume(origin, dims, voxel, device="cpu")
    for j, p in zip(jc, pc):
        jv = jtsdf.integrate(jv, jnp.asarray(j.depth), jnp.asarray(j.image),
                             jnp.asarray(j.w2c, jnp.float32),
                             jnp.asarray(j.K, jnp.float32), max_depth=8.0)
        pv = tsdf.integrate(pv, torch.as_tensor(p.depth),
                            torch.as_tensor(p.image),
                            torch.as_tensor(p.w2c, dtype=torch.float32),
                            torch.as_tensor(p.K, dtype=torch.float32),
                            max_depth=8.0)
    assert (pv.weight.numpy() == np.asarray(jv.weight)).all()
    assert float(pv.weight.max()) == 3.0
    np.testing.assert_allclose(pv.tsdf.numpy(), np.asarray(jv.tsdf), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pv.color.numpy(), np.asarray(jv.color),
                               atol=1e-5, rtol=0)
    jp, jcol, jval = jtsdf.extract_surface_points(jv)
    pp, pcol, pval = tsdf.extract_surface_points(pv)
    assert (pval.numpy() == np.asarray(jval)).all() and int(pval.sum()) > 100
    np.testing.assert_allclose(pp.numpy()[pval.numpy()],
                               np.asarray(jp)[np.asarray(jval)], atol=1e-5)
    np.testing.assert_allclose(pcol.numpy()[pval.numpy()],
                               np.asarray(jcol)[np.asarray(jval)], atol=1e-5)


def test_fuse_frames_matches_jax(frames):
    jc, pc = frames
    jv = jtsdf.fuse_frames(jc, [j.depth for j in jc], [j.image for j in jc],
                           voxel_size=0.1)
    pv = tsdf.fuse_frames(pc, [p.depth for p in pc], [p.image for p in pc],
                          voxel_size=0.1, device="cpu")
    assert pv.tsdf.shape == jv.tsdf.shape
    assert (pv.origin.numpy() == np.asarray(jv.origin)).all()
    assert pv.voxel == jv.voxel and pv.trunc == jv.trunc
    assert (pv.weight.numpy() == np.asarray(jv.weight)).all()
    np.testing.assert_allclose(pv.tsdf.numpy(), np.asarray(jv.tsdf), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pv.color.numpy(), np.asarray(jv.color),
                               atol=1e-5, rtol=0)


def _sphere_volume(n=32, r=0.35):
    lin = (np.arange(n) + 0.5) / n - 0.5
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    d = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - r
    tsdf_ = np.clip(d / (4.0 / n), -1, 1).astype(np.float32)
    color = np.stack([gx, gy, gz], -1).astype(np.float32) + 0.5
    return tsdf_, np.full_like(tsdf_, 5.0), 1.0 / n, color


def test_marching_tetrahedra_matches_jax(tmp_path):
    t, w, voxel, color = _sphere_volume()
    pv, pf, pc = marching.marching_tetrahedra(t, w, (0.1, 0.2, 0.3), voxel,
                                              color)
    jv, jf, jcol = jmarch.marching_tetrahedra(t, w, (0.1, 0.2, 0.3), voxel,
                                              color)
    assert len(pf) > 500
    assert (pv == jv).all() and (pf == jf).all() and (pc == jcol).all()
    assert (marching.sample_mesh_points(pv, pf, 1000, seed=3)
            == jmarch.sample_mesh_points(jv, jf, 1000, seed=3)).all()
    marching.write_mesh_ply(str(tmp_path / "a.ply"), pv, pf, pc)
    jmarch.write_mesh_ply(str(tmp_path / "b.ply"), jv, jf, jcol)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    empty = marching.marching_tetrahedra(np.ones((6, 6, 6), np.float32),
                                         np.ones((6, 6, 6), np.float32),
                                         (0, 0, 0), 0.1)
    assert len(empty[0]) == 0 and len(empty[1]) == 0


def test_box_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    gt_rows = []
    for i in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        gt_rows.append([10 + i % 3, *rng.uniform(-1, 1, 3), *q,
                        *rng.uniform(0.1, 0.5, 3)])
    pred_rows = [[r[0], *(np.array(r[1:4]) + rng.normal(0, 0.05, 3)),
                  *r[4:8], *(np.array(r[8:11]) * rng.uniform(0.8, 1.2, 3))]
                 for r in gt_rows[:5]]
    for name, rows in (("gt.txt", gt_rows), ("pred.txt", pred_rows)):
        with open(tmp_path / name, "w") as f:
            f.write("# cat tx ty tz qx qy qz qw a1 a2 a3\n")
            f.writelines(" ".join(str(x) for x in r) + "\n" for r in rows)
    pg, jg = (lib.load_box_file(str(tmp_path / "gt.txt")) for lib in (obj_eval, jobj))
    pp, jp = (lib.load_box_file(str(tmp_path / "pred.txt")) for lib in (obj_eval, jobj))
    for a, b in zip(pg + pp, jg + jp):
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-12)
        assert a.category == b.category and a.volume == b.volume
    ious = [obj_eval.box_iou(a, b) for a, b in zip(pp, pg)]
    np.testing.assert_allclose(ious, [jobj.box_iou(a, b) for a, b in zip(jp, jg)],
                               atol=1e-6)
    assert min(ious) > 0.2 and obj_eval.box_iou(pg[0], pg[0]) == pytest.approx(1.0)
    got, want = obj_eval.evaluate_boxes(pp, pg), jobj.evaluate_boxes(jp, jg)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    scores = rng.uniform(size=len(pp))
    for kw in ({}, {"scores": scores}):
        got, want = (obj_eval.compute_ap_curve(pp, pg, **kw),
                     jobj.compute_ap_curve(jp, jg, **kw))
        assert got["thresholds"] == want["thresholds"]
        np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-6)
        assert got["mean_ap"] == pytest.approx(want["mean_ap"], abs=1e-6)
    got, want = (obj_eval.object_center_errors(pp, pg),
                 jobj.object_center_errors(jp, jg))
    assert got["n_matched"] == want["n_matched"] == 5
    assert got["mean_center_err_cm"] == pytest.approx(
        want["mean_center_err_cm"], abs=1e-6)


def test_load_gt_mesh_points_matches_jax(tmp_path):
    t, w, voxel, _ = _sphere_volume(n=16)
    v, f, _ = marching.marching_tetrahedra(t, w, (0, 0, 0), voxel)
    marching.write_mesh_ply(str(tmp_path / "m.ply"), v, f)
    got = obj_eval.load_gt_mesh_points(str(tmp_path / "m.ply"), n=500, seed=2)
    want = jobj.load_gt_mesh_points(str(tmp_path / "m.ply"), n=500, seed=2)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _sphere_map(n=4000, r=0.3, centre=(0.0, 0.0, 2.0), seed=0):
    """A map of small opaque Gaussians on a sphere, object 0, as numpy
    fields of either package's MapState, and its GT surface points."""
    from dqo_map_tpu.models import gaussian_map as jgm
    rng = np.random.default_rng(seed)
    d = {k: np.array(v) for k, v in jgm.empty_map(4096)._asdict().items()}
    p = rng.normal(size=(n, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True)
    d["xyz"][:n] = p * r + np.asarray(centre)
    d["scaling"][:n] = np.log(0.01)
    d["rotation"][:n] = (1.0, 0.0, 0.0, 0.0)
    d["opacity"][:n] = 4.0
    d["sh"][:n, 0] = 0.5
    d["status"][:n] = jgm.STABLE
    d["obj_id"][:n] = 0
    d["count"] = np.int32(n)
    g = rng.normal(size=(3000, 3))
    g = g / np.linalg.norm(g, axis=1, keepdims=True) * r + np.asarray(centre)
    return d, g.astype(np.float32)


def test_per_object_mesh_eval_matches_jax():
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu.models import gaussian_map as jgm
    from dqo_map_tpu.models.cameras import Camera as JCamera
    from dqo_map_tpu.slam.mapper import Mapping as JMapping
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.convert import map_state_from_numpy
    from dqo_map_tpu_torch.models.cameras import Camera
    from dqo_map_tpu_torch.slam.mapper import Mapping
    d, gt = _sphere_map()
    cfg = dict(capacity=4096)
    jm = JMapping(jax_default_config(**cfg), W, H)
    jm.state = jgm.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    pm = Mapping(default_config(**cfg), W, H, "cpu")
    pm.state = map_state_from_numpy(d, "cpu")
    from dqo_map_tpu.data.synthetic import _look_at
    cams = {}
    for lib, cls in (("jax", JCamera), ("port", Camera)):
        cams[lib] = []
        for i, ang in enumerate(np.linspace(-0.6, 0.6, 4)):
            eye = np.array([1.2 * np.sin(ang), 0.1, 2.0 - 1.2 * np.cos(ang)])
            cams[lib].append(cls(uid=i, c2w=_look_at(eye, (0.0, 0.0, 2.0)),
                                 fx=48.0, fy=48.0, cx=W / 2, cy=H / 2,
                                 width=W, height=H))
    kw = dict(voxel_size=0.02, dist_thresh=0.02)
    got = obj_eval.per_object_mesh_eval(pm, cams["port"], {0: gt, 5: gt}, **kw)
    want = jobj.per_object_mesh_eval(jm, cams["jax"], {0: gt, 5: gt}, **kw)
    assert set(got) == set(want) == {0}
    g, w = got[0], want[0]
    assert g["n_gaussians"] == w["n_gaussians"] == 4000
    assert abs(g["n_mesh_verts"] - w["n_mesh_verts"]) <= 0.01 * w["n_mesh_verts"]
    for k in ("chamfer_cm", "accuracy_cm", "completion_cm"):
        assert g[k] == pytest.approx(w[k], abs=2e-3), k
    for k in ("precision", "recall", "f1"):
        assert g[k] == pytest.approx(w[k], abs=2e-3), k
    # the visible half of the sphere, meshed from 2 cm voxels
    assert g["accuracy_cm"] < 2.0 and g["precision"] > 0.7


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A port run of 4 frames of the synthetic room at 64x48 with the object
    layer, on the CPU, and a config for the CLIs: the Synthetic reader's
    frames (160x120) over the same 4-frame orbit."""
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    out = tmp_path_factory.mktemp("run")
    run = str(out / "run")
    _, cams = synthetic_sequence(4, width=W, height=H, with_detections=True)
    cfg = default_config(
        type="Synthetic", save_path=run, use_object=True, use_gt_pose=True,
        capacity=16384, add_capacity=4096, uniform_sample_num=1500,
        gaussian_update_frame=2, gaussian_update_iter=4, final_global_iter=1,
        stable_confidence_thres=2, min_depth=0.1, max_depth=8.0,
        memory_length=3)
    system = SLAMSystem(cfg, cameras=cams, device="cpu")
    system.run(eval_every=0, verbose=False)
    config = out / "config.yaml"
    config.write_text("parent: configs/synthetic/room.yaml\nframe_num: 4\n"
                      f"save_path: {run}\n")
    return run, str(config), system


def _cli(*args):
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout


def test_make_mesh_cli(tiny_run, tmp_path):
    run, config, _ = tiny_run
    gt = tmp_path / "gt.npy"
    _, cams = synthetic_sequence(1, width=W, height=H)
    from dqo_map_tpu_torch.utils.image import compute_vertex_map, transform_map
    v = transform_map(compute_vertex_map(torch.as_tensor(cams[0].depth),
                                         torch.as_tensor(cams[0].K, dtype=torch.float32)),
                      torch.as_tensor(cams[0].c2w, dtype=torch.float32))
    np.save(gt, v.reshape(-1, 3).numpy()[::8])
    out = _cli("dqo_map_tpu_torch.cli.make_mesh", "--config", config,
               "--model", run, "--voxel", "0.1", "--frame-step", "2",
               "--gt-mesh", str(gt), "--device", "cpu")
    mesh = os.path.join(run, "save_model", "mesh.ply")
    verts, faces = read_mesh_ply(mesh)
    assert len(faces) > 100 and faces.max() < len(verts)
    assert os.path.getsize(os.path.join(run, "save_model",
                                        "tsdf_surface.ply")) > 1000
    assert "mesh eval:" in out and "rendered frame 2" in out


def test_metric_obj_cli(tiny_run, tmp_path):
    run, _, system = tiny_run
    layer = system.object_layer
    assert len(layer.objects) >= 1
    pred = os.path.join(run, "save_obj", "objects.txt")
    res = json.loads(_cli("dqo_map_tpu_torch.cli.metric_obj", "--pred", pred,
                          "--gt", pred))
    assert res["mean_iou"] == pytest.approx(1.0, abs=1e-6)
    assert res["accuracy@0.5"] == 1.0 and res["n_pred"] == len(layer.objects)
    assert res["ap_curve"]["mean_ap"] == 1.0
    # per object: the exported Gaussians of each object against themselves
    import glob
    plys = sorted(glob.glob(os.path.join(run, "save_model", "*", "*_obj*.ply")))
    assert plys
    oid = int(plys[-1].rsplit("_obj", 1)[1].split(".")[0])
    pts = read_gaussian_ply(plys[-1])["xyz"]
    gt = tmp_path / f"gt{oid}.ply"
    write_point_normal_ply(str(gt), pts, np.zeros_like(pts))
    res = json.loads(_cli("dqo_map_tpu_torch.cli.metric_obj", "--per-object",
                          run, "--gt-mesh", f"{oid}={gt}", "--device", "cpu"))
    assert list(res) == [str(oid)]
    assert res[str(oid)]["n_points"] == len(pts)
    assert res[str(oid)]["accuracy_cm"] < 1e-3 and res[str(oid)]["f1"] == 1.0


def test_ablate_assoc_cli(tmp_path):
    out = _cli("dqo_map_tpu_torch.cli.ablate_assoc", "--synthetic", "6",
               "--out", str(tmp_path), "--device", "cpu")
    rows = [line.split() for line in out.splitlines()[-3:]]
    assert [r[0] for r in rows] == ["iou", "qd", "iou_qd"]
    assert all(int(r[1]) >= 1 and int(r[2]) >= int(r[1]) for r in rows)
    for d in ("only_iou", "only_qd", "iou_qd"):
        assert os.path.isfile(tmp_path / d / "objects.txt")
