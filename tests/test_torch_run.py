"""The port's run tail and its host modules against the JAX package's, on
the CPU: evaluation (`eval/evaluate.py`, `utils/losses.py`), PLY export
(`utils/ply.py`), checkpoints (`utils/checkpoint.py`, `convert.py`),
dataset readers (`data/readers.py`), trajectories (`Tracker.save_traj`,
`cli/eval_ate.py`), and the whole `SLAMSystem.run()` and `run_slam` CLI at
160x120.

Tolerances: the metrics of one render to 1e-5 relative (the same float32
formulas on the same inputs; the sums run in another order), the
valid-pixel ratio exactly; PLY files byte for byte; checkpoints, readers
and trajectory files exactly but the poses, to 1e-12 (the same float64
operations in numpy). The end-to-end run is held to finish and to write
every file the JAX package's `run()` writes, with the same result keys; its
numbers are not compared (the two packages' scans drift apart on a real
sequence, `test_torch_slice_optimize.py`).
"""

import contextlib
import io
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml
from PIL import Image

from dqo_map_tpu.models import gaussian_map as jgm
from dqo_map_tpu_torch.convert import (map_state_from_checkpoint,
                                       map_state_from_numpy,
                                       map_state_to_numpy)
from dqo_map_tpu_torch.models import gaussian_map as gm

W, H = 160, 120
RUN = dict(type="Synthetic", use_object=False, use_gt_pose=False,
           use_orb_backend=False, capacity=16384, add_capacity=4096,
           uniform_sample_num=1000, gaussian_update_frame=3,
           gaussian_update_iter=4, final_global_iter=2,
           stable_confidence_thres=5, min_depth=0.1, max_depth=8.0,
           memory_length=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its runs are many small
    operations, which threads do not speed up, and beside the other test
    workers the thread pools' waits cost several times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def random_map(rng):
    """A map of 900 of 1024 slots with a random mix of statuses, as numpy
    fields of the JAX package's `MapState`."""
    n, cap = 900, 1024
    d = {k: np.array(v) for k, v in jgm.empty_map(cap)._asdict().items()}
    d["xyz"][:n] = rng.uniform(-1, 1, (n, 3))
    d["scaling"][:n] = rng.uniform(np.log(0.005), np.log(0.05), (n, 3))
    d["rotation"][:n] = rng.normal(size=(n, 4))
    d["opacity"][:n] = rng.normal(size=n)
    d["sh"][:n] = rng.normal(size=(n, 16, 3)) * 0.1
    d["confidence"][:n] = rng.uniform(0, 40, n)
    d["status"][:n] = rng.integers(0, 3, n)
    d["obj_id"][:n] = rng.integers(-1, 3, n)
    d["count"] = np.int32(n)
    return d


def _jstate(d):
    return jgm.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# (b) evaluation
# ---------------------------------------------------------------------------

def _render_dict(rng, h, w):
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    gtd = rng.uniform(0.05, 6.0, (h, w)).astype(np.float32)
    render = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    depth = (gtd + rng.normal(0, 0.02, gtd.shape)).astype(np.float32)
    index = rng.integers(-1, 50, (h, w)).astype(np.int32)
    return {"render": render, "depth": depth, "depth_index_map": index}, gt, gtd


@pytest.mark.parametrize("size", [(48, 64), (180, 200)])
def test_eval_picture_matches_jax(rng, tmp_path, size):
    """Every metric of one render to 1e-5 relative, the valid ratio
    exactly, the same keys; at 180x200 MS-SSIM uses all five scales. The
    comparison images decode to the render, the frame and the error."""
    from dqo_map_tpu.eval.evaluate import eval_picture as jeval
    from dqo_map_tpu_torch.eval.evaluate import eval_picture
    out, gt, gtd = _render_dict(rng, *size)
    ref = jeval({k: jnp.asarray(v) for k, v in out.items()}, gt, gtd, 0.1,
                5.0, save_path=str(tmp_path / "jax"))
    got = eval_picture({k: torch.as_tensor(v) for k, v in out.items()}, gt,
                       gtd, 0.1, 5.0, save_path=str(tmp_path))
    assert set(got) == set(ref)
    assert got["lpips"] is ref["lpips"] is None
    assert got["lpips_note"] == ref["lpips_note"]
    assert got["valid_ratio"] == ref["valid_ratio"]
    for k in ("psnr", "ssim", "ms_ssim", "color_l1", "depth_l1_cm"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)

    # JAX's JPEGs (PIL, quality 75), byte for byte, of the strips
    u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)  # noqa: E731
    img = out["render"]
    gate = np.where((gtd > 0.1) & (gtd < 5.0), gtd, 0.0)
    strips = {"color_compare.jpg": u8(np.concatenate([img, gt, np.abs(img - gt)],
                                                     1)),
              "depth_compare.jpg": u8(np.concatenate([out["depth"], gate], 1)
                                      / gate.max())}
    for name, strip in strips.items():
        data = (tmp_path / name).read_bytes()
        assert data == (tmp_path / "jax" / name).read_bytes(), name
        buf = io.BytesIO()
        Image.fromarray(strip).save(buf, "JPEG", quality=75)
        assert data == buf.getvalue(), name


def test_loss_helpers_match_jax(rng):
    from dqo_map_tpu.utils import losses as jlosses
    from dqo_map_tpu_torch.utils import losses
    a = rng.uniform(0, 1, (3, 40, 52)).astype(np.float32)
    b = rng.uniform(0, 1, (3, 40, 52)).astype(np.float32)
    mask = rng.uniform(size=(40, 52)) < 0.3
    ta, tb, tm = torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(mask)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(losses.l2_loss(ta, tb)),
                               float(jlosses.l2_loss(ja, jb)), rtol=1e-6)
    at, bt = ta.permute(1, 2, 0), tb.permute(1, 2, 0)
    np.testing.assert_allclose(
        float(losses.masked_l1(at, bt, tm)),
        float(jlosses.masked_l1(jnp.transpose(ja, (1, 2, 0)),
                                jnp.transpose(jb, (1, 2, 0)),
                                jnp.asarray(mask))), rtol=1e-6)
    assert float(losses.masked_l1(at, bt, torch.zeros_like(tm))) == 0.0
    np.testing.assert_allclose(float(losses.ms_ssim(ta, tb)),
                               float(jlosses.ms_ssim(ja, jb)), rtol=1e-5)


def test_eval_pcd_matches_jax(rng):
    from dqo_map_tpu.eval.evaluate import eval_pcd as jeval_pcd
    from dqo_map_tpu_torch.eval.evaluate import eval_pcd
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    gt = (pts[:500] + rng.normal(0, 0.02, (500, 3))).astype(np.float32)
    ref = jeval_pcd(pts, gt, sample=600)
    got = eval_pcd(pts, gt, sample=600, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# (c) PLY
# ---------------------------------------------------------------------------

def test_ply_files_match_jax(random_map, tmp_path):
    """`save_map_ply` of one state writes the same bytes in both packages,
    for every subset and an object mask; a PLY the JAX package wrote loads
    through the port's `load_map_ply` to the JAX package's map; the
    disc-densified cloud and its file agree."""
    from dqo_map_tpu.utils import ply as jply
    from dqo_map_tpu_torch.utils import ply
    js = _jstate(random_map)
    ps = map_state_from_numpy(random_map, "cpu")
    obj = random_map["obj_id"] == 1
    for subset, mask in (("global", None), ("stable", None),
                         ("unstable", None), ("global", obj)):
        a, b = tmp_path / "jax.ply", tmp_path / "port.ply"
        jply.save_map_ply(js, str(a), subset=subset, mask=mask)
        ply.save_map_ply(ps, str(b), subset=subset, mask=mask)
        assert a.read_bytes() == b.read_bytes(), subset

    jply.save_map_ply(js, str(tmp_path / "m.ply"), subset="global")
    ref = jply.load_map_ply(str(tmp_path / "m.ply"), 2048)
    got = ply.load_map_ply(str(tmp_path / "m.ply"), 2048, device="cpu")
    g, r = map_state_to_numpy(got), {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert int(g["count"]) == int(r["count"]) == int((random_map["status"] != 0).sum())
    for k in g:
        assert g[k].dtype == r[k].dtype and (g[k] == r[k]).all(), k

    jp, jn = jply.densify_point_cloud(js, circle_num=6, levels=2)
    pp, pn = ply.densify_point_cloud(ps, circle_num=6, levels=2)
    assert pp.shape == jp.shape == (6 * 2 * int((random_map["status"] == 2).sum()), 3)
    np.testing.assert_allclose(pp, jp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pn, jn, atol=1e-5, rtol=0)
    jply.write_point_normal_ply(str(tmp_path / "a.ply"), jp, jn)
    ply.write_point_normal_ply(str(tmp_path / "b.ply"), jp, jn)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    (gv, gf), (rv, rf) = (ply.read_mesh_ply(str(tmp_path / "a.ply")),
                          jply.read_mesh_ply(str(tmp_path / "a.ply")))
    assert (gv == rv).all() and gf is rf is None


# ---------------------------------------------------------------------------
# (d) checkpoints
# ---------------------------------------------------------------------------

def _run_cfg(tmp_path, **kw):
    from dqo_map_tpu_torch.config import default_config
    return default_config(**dict(RUN, save_path=str(tmp_path), **kw))


def test_jax_checkpoint_reads_to_jax_map(random_map, tmp_path):
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu.data.synthetic import synthetic_sequence
    from dqo_map_tpu.slam.system import SLAMSystem as JSLAMSystem
    _, cams = synthetic_sequence(1, width=32, height=24)
    jsys = JSLAMSystem(jax_default_config(**dict(RUN, save_path=str(tmp_path))),
                       cameras=cams)
    jsys.mapping.state = _jstate(random_map)
    path = jsys.save_checkpoint(str(tmp_path / "ck"))
    got = map_state_to_numpy(map_state_from_checkpoint(path, "cpu"))
    for k, v in random_map.items():
        assert got[k].dtype == np.asarray(v).dtype and (got[k] == v).all(), k


def test_checkpoint_round_trip_is_exact(tmp_path):
    """Three frames with a scan, saved and resumed into a fresh system: the
    map, the keyframes and memory frames, the poses, the time, both random
    streams and the render at the last camera come back exactly."""
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    _, cams = synthetic_sequence(3, width=64, height=48)
    cfg = _run_cfg(tmp_path, capacity=8192, gaussian_update_frame=2)
    a = SLAMSystem(cfg, cameras=cams, device="cpu")
    for i in range(3):
        a.step(cams[i], i)
        a.mapping.time += 1
    path = a.save_checkpoint()
    assert path == str(tmp_path / "checkpoint" / "ckpt_00003.npz")
    b = SLAMSystem(cfg, cameras=cams, device="cpu")
    assert b.resume(path) == 3
    ma, mb = a.mapping, b.mapping
    sa, sb = map_state_to_numpy(ma.state), map_state_to_numpy(mb.state)
    for k in sa:
        assert (sa[k] == sb[k]).all(), k
    assert mb.keyframe_ids == ma.keyframe_ids and mb.time == ma.time == 3
    assert mb.optimize_frames_ids == ma.optimize_frames_ids
    for (ca, ia, ka), (cb, ib, kb) in zip(ma.keyframes, mb.keyframes):
        assert ca is cb
        for k in ka:
            assert torch.equal(ka[k], kb[k]), k
        for k in ("w2c", "full_proj", "K"):
            assert torch.equal(ia[k], ib[k]), k
    assert len(mb.processed_frames) == len(ma.processed_frames)
    assert torch.equal(mb.processed_frames[-1][1]["vertex_pyr"][0],
                       ma.processed_frames[-1][1]["vertex_pyr"][0])
    for pa, pb in zip(a.tracker.poses_np(), b.tracker.poses_np()):
        assert (pa == pb).all()
    assert b.recorder.means == a.recorder.means
    assert (mb._host_rng.bit_generator.state == ma._host_rng.bit_generator.state)
    assert all(torch.equal(x, y) for x, y in zip(ma._uniform_draws(50),
                                                 mb._uniform_draws(50)))
    cin = cams[-1].render_inputs("cpu")
    ra, rb = ma.get_render_output(cin), mb.get_render_output(cin)
    for k in ("render", "depth", "depth_index_map", "T_map"):
        assert torch.equal(ra[k], rb[k]), k


# ---------------------------------------------------------------------------
# (e) readers
# ---------------------------------------------------------------------------

def _write_rgbd(rgb_path, depth_path, seed, depth_scale):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)).save(rgb_path)
    d = (rng.uniform(0.5, 3.0, (24, 32)) * depth_scale).astype(np.uint16)
    Image.fromarray(d).save(depth_path)


def _replica(root):
    (root / "scene" / "results").mkdir(parents=True)
    (root / "cam_params.json").write_text(json.dumps({"camera": {
        "fx": 24.0, "fy": 25.0, "cx": 16.0, "cy": 12.0, "scale": 6553.5}}))
    rng, lines = np.random.default_rng(3), []
    for i in range(3):
        _write_rgbd(root / "scene" / "results" / f"frame{i:06d}.jpg",
                    root / "scene" / "results" / f"depth{i:06d}.png", i, 6553.5)
        pose = np.eye(4)
        pose[:3, 3] = rng.normal(size=3)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        lines.append(" ".join(repr(float(x)) for x in pose.reshape(-1)))
    (root / "scene" / "traj.txt").write_text("\n".join(lines) + "\n")
    return str(root / "scene")


def _tum(root):
    for d in ("rgb", "depth"):
        (root / d).mkdir()
    rgb, dep, gt = [], [], []
    for i in range(3):
        t = 100.0 + 0.05 * i
        _write_rgbd(root / "rgb" / f"{t:.4f}.png", root / "depth" / f"{t:.4f}.png",
                    10 + i, 5000.0)
        rgb.append(f"{t:.4f} rgb/{t:.4f}.png")
        dep.append(f"{t + 0.004:.4f} depth/{t:.4f}.png")
        gt.append(f"{t:.4f} {0.1 * i} {0.02 * i} 0 0 {0.1 * i} 0 1")
    for name, lines in (("rgb", rgb), ("depth", dep), ("groundtruth", gt)):
        (root / f"{name}.txt").write_text("# x\n" + "\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("kind", ["Replica", "TUM"])
def test_readers_match_jax(tmp_path, kind):
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu.data.readers import Dataset as JDataset
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data import Dataset
    src = _replica(tmp_path) if kind == "Replica" else _tum(tmp_path)
    cfg = dict(type=kind, source_path=src, crop_edge=2 if kind == "TUM" else 0)
    ref = JDataset(jax_default_config(**cfg).dataset)
    got = Dataset(default_config(**cfg).dataset)
    assert len(got) == len(ref) == 3
    for g, r in zip(got.cameras, ref.cameras):
        assert (g.image == r.image).all() and (g.depth == r.depth).all()
        assert g.image.dtype == r.image.dtype and g.depth.dtype == r.depth.dtype
        np.testing.assert_allclose(g.c2w, r.c2w, atol=1e-12, rtol=0)
        np.testing.assert_allclose(g.pose_gt, r.pose_gt, atol=1e-12, rtol=0)
        assert (g.K == r.K).all() and (g.width, g.height) == (r.width, r.height)
        assert g.timestamp == r.timestamp and g.uid == r.uid
    assert got[1].width == (28 if kind == "TUM" else 32)


# ---------------------------------------------------------------------------
# (f) trajectories
# ---------------------------------------------------------------------------

def test_save_traj_and_eval_ate_match_jax(tmp_path, rng):
    from dqo_map_tpu.cli import eval_ate as jeval_ate
    from dqo_map_tpu.config import default_config as jax_default_config
    from dqo_map_tpu.slam.tracker import Tracker as JTracker
    from dqo_map_tpu_torch.cli import eval_ate
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.slam.tracker import Tracker
    from scipy.spatial.transform import Rotation
    n = 12
    gt, es = [], []
    for i in range(n):
        p = np.eye(4)
        p[:3, :3] = Rotation.from_euler("xyz", rng.normal(0, 0.2, 3)).as_matrix()
        p[:3, 3] = [0.1 * i, 0.05 * np.sin(i), 0.0]
        q = p.copy()
        q[:3, 3] += rng.normal(0, 0.01, 3)
        gt.append(p)
        es.append(q)
    stamps = [1305031102.175304 + 0.033 * i for i in range(n)]
    jt = JTracker(jax_default_config().tracking, 32, 24)
    pt = Tracker(default_config().tracking, 32, 24, "cpu")
    out = {}
    for name, t in (("jax", jt), ("port", pt)):
        t.pose_es = [np.array(p) for p in es]
        t.pose_gt = [np.array(p) for p in gt]
        t.timestamps = list(stamps)
        out[name] = t.save_traj(str(tmp_path / name))
    assert out["port"] == out["jax"] and out["port"] > 0
    for f in ("pose_es.npy", "pose_gt.npy", "poses.txt", "ate.txt"):
        a = (tmp_path / "jax" / "save_traj" / f).read_bytes()
        assert (tmp_path / "port" / "save_traj" / f).read_bytes() == a, f

    # the ground truth as a TUM file, by the same writer
    pt.pose_es = [np.array(p) for p in gt]
    pt.save_traj(str(tmp_path / "gt"))
    args = [str(tmp_path / "gt" / "save_traj" / "poses.txt"),
            str(tmp_path / "port" / "save_traj" / "poses.txt"), "--verbose",
            "--save_associations"]
    prints = {}
    for name, mod in (("jax", jeval_ate), ("port", eval_ate)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = mod.main(args + [str(tmp_path / f"assoc_{name}.txt")])
        prints[name] = (buf.getvalue(), stats)
    assert prints["port"] == prints["jax"]
    assert prints["port"][1]["pairs"] == n
    assert ((tmp_path / "assoc_port.txt").read_bytes()
            == (tmp_path / "assoc_jax.txt").read_bytes())


# ---------------------------------------------------------------------------
# (g) end to end
# ---------------------------------------------------------------------------

def _jax_result_keys(tmp_path) -> set:
    """The keys of the JAX package's `run()` result less its object keys
    (`system.py:255-266`): the final `eval_picture` metrics, `ate_cm`, and
    what its Recorder saves after the tracking and mapping means."""
    from dqo_map_tpu.eval.evaluate import eval_picture
    from dqo_map_tpu.utils.monitor import Recorder
    out, gt, gtd = _render_dict(np.random.default_rng(0), 24, 32)
    final = eval_picture({k: jnp.asarray(v) for k, v in out.items()}, gt, gtd,
                         0.1, 5.0)
    rec = Recorder()
    rec.update_mean("tracking", 0.1)
    rec.update_mean("mapping", 0.1)
    rec.cal_fps()
    return set(final) | {"ate_cm"} | set(rec.save(str(tmp_path / "rec")))


def _run_files(root) -> set:
    files = set()
    for d, _, names in os.walk(root):
        files |= {os.path.relpath(os.path.join(d, f), root) for f in names}
    return files


def test_run_end_to_end(tmp_path, monkeypatch):
    """`SLAMSystem.run()` over 4 frames at 160x120: periodic evaluation,
    the final pass (2 steps a keyframe), every output file, and the scans'
    curves in `scalars.jsonl` (`use_tensorboard`; its TensorBoard mirror,
    optional, is hidden here)."""
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    _, cams = synthetic_sequence(4, width=W, height=H)
    out = tmp_path / "run"
    system = SLAMSystem(_run_cfg(out, pcd_densify=True, use_tensorboard=True),
                        cameras=cams, device="cpu")
    result = system.run(eval_every=2, verbose=False)
    assert set(result) == _jax_result_keys(tmp_path)
    assert np.isfinite(result["psnr"]) and result["psnr"] > 15
    assert np.isfinite(result["ate_cm"]) and result["max_mem_GB"] == 0.0
    m = system.mapping
    assert m.scan_counts["final"] == 1
    assert m.optimize_frames_ids == [0, 2]
    assert m.scan_counts["local"] + m.scan_counts["global"] == 2
    assert m.scan_counts["iters"] == 2 * 4 + len(m.keyframes) * 2
    assert [h["frame"] for h in system.metrics_history] == [0, 1, 3, "final"]
    assert int((m.state.status == gm.UNSTABLE).sum()) == 0
    logged = [json.loads(x) for x in (out / "scalars.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in logged}
    assert {"local/total_loss", "final/total_loss", "final/ssim_loss"} <= tags
    assert ([r["tag"].split("/")[0] for r in logged if r["tag"].endswith("/iters")]
            == [kind for kind, _ in m.scan_log])
    assert _run_files(out) == {
        "scalars.jsonl",
        "performance.json", "eval_render/color_compare.jpg",
        "eval_render/depth_compare.jpg", "save_traj/pose_es.npy",
        "save_traj/pose_gt.npy", "save_traj/poses.txt", "save_traj/ate.txt",
        "save_model/frame_0004/iter_0000_stable.ply",
        "save_model/frame_0004/iter_0000_merge.ply",
        "save_model/pcd_densify.ply"}


def _tail_system(pkg, tmp_path, raising):
    """A system of `pkg` whose `run()` goes straight to its tail (no frame,
    the final pass, evaluation and map export stubbed), with the object
    layer, and with `save_traj` and / or `record_iou` raising."""
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    if pkg == "jax":
        from dqo_map_tpu.config import default_config
        from dqo_map_tpu.data.synthetic import synthetic_sequence as seq
        from dqo_map_tpu.slam import system as mod
        _, cams = seq(1, width=32, height=24)
        kw = {}
    else:
        from dqo_map_tpu_torch.config import default_config
        from dqo_map_tpu_torch.slam import system as mod
        _, cams = synthetic_sequence(1, width=32, height=24)
        kw = {"device": "cpu"}
    out = tmp_path / pkg
    system = mod.SLAMSystem(default_config(**dict(
        RUN, save_path=str(out), use_object=True)), cameras=cams, **kw)
    system.mapping.global_optimization = lambda *a, **k: None
    system.mapping.save_model = lambda *a, **k: None
    for name in ("_save_object_passes", "save_object_passes"):
        setattr(system, name, lambda *a, **k: None)

    def fail(what):
        def raiser(*a, **k):
            raise OSError(f"{what} cannot write")
        return raiser

    system.tracker.save_traj = (fail("save_traj") if "save_traj" in raising
                                else lambda path: 0.5)
    if "record_iou" in raising:
        system.object_layer.record_iou = fail("record_iou")
    return system, mod, out


@pytest.mark.parametrize("raising", [("save_traj",), ("record_iou",),
                                     ("save_traj", "record_iou")],
                         ids=["traj", "iou", "both"])
def test_run_tail_survives_as_jax(tmp_path, monkeypatch, capsys, raising):
    """A failing trajectory write or IoU log is printed and the run carries
    on to `performance.json` in both packages; `ate_cm` is None where the
    trajectory failed."""
    results, printed = {}, {}
    metrics = {"psnr": 30.0, "depth_l1_cm": 1.0}
    for pkg in ("jax", "port"):
        system, mod, out = _tail_system(pkg, tmp_path, raising)
        monkeypatch.setattr(mod, "eval_frame", lambda *a, **k: dict(metrics))
        capsys.readouterr()
        results[pkg] = system.run(eval_every=0, verbose=False, max_frames=0)
        printed[pkg] = [x for x in capsys.readouterr().out.splitlines()
                        if x.startswith("[slam]")]
        assert (out / "performance.json").exists()
        assert (out / "save_obj" / "iou.txt").exists() == (
            "record_iou" not in raising)
    assert printed["port"] == printed["jax"] == [
        f"[slam] {'traj save' if w == 'save_traj' else w} failed: {w} "
        "cannot write" for w in ("save_traj", "record_iou") if w in raising]
    for r in results.values():
        assert r["psnr"] == 30.0
        assert r["ate_cm"] == (None if "save_traj" in raising else 0.5)


def test_system_takes_a_dataset_as_jax(tmp_path):
    """`SLAMSystem(cfg, dataset=...)` runs over the dataset's cameras, as
    the JAX package's does; `cameras` wins over it."""
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    class Frames:
        def __init__(self, n):
            self.cameras = synthetic_sequence(n, width=32, height=24)[1]

    cfg = _run_cfg(tmp_path)
    ds = Frames(3)
    system = SLAMSystem(cfg, dataset=ds, device="cpu")
    assert system.cameras is ds.cameras and system.width == 32
    other = Frames(2).cameras
    assert SLAMSystem(cfg, dataset=ds, cameras=other,
                      device="cpu").cameras is other


def test_run_slam_cli_and_metric_cli(tmp_path):
    """`run_slam.main([... "--device", "cpu"])` on a Synthetic config of 4
    frames: result.json with the JAX CLI's keys; then the `metric` CLI
    re-renders the saved map over the frames."""
    from dqo_map_tpu_torch.cli import metric, run_slam
    out = tmp_path / "run"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(RUN, frame_num=4,
                                            save_path=str(out))))
    with contextlib.redirect_stdout(io.StringIO()):
        scalars = run_slam.main(["--config", str(cfg_path), "--device", "cpu",
                                 "--max-frames", "4", "--quiet"])
    saved = json.loads((out / "result.json").read_text())
    assert set(saved) == _jax_result_keys(tmp_path)
    assert saved == json.loads(json.dumps(scalars))
    assert (out / "config.yaml").exists()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = metric.main(["--config", str(cfg_path), "--model", str(out),
                            "--frame-step", "2", "--capacity", "16384",
                            "--device", "cpu"])
    assert [r["frame"] for r in rows] == [0, 2]
    assert all(np.isfinite(r["psnr"]) and r["psnr"] > 10 for r in rows)
    assert (out / "eval_metric" / "statis.csv").exists()
