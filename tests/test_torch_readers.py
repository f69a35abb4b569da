"""The port's dataset readers against the JAX package's on the same files,
with PIL hidden from the port, on the CPU.

Each layout is written in `tmp_path` with PIL: Replica with semantics and
detections (JPEG colour, one semantic PNG at another size), Ours /
ScanNet++ with colour at twice the depth's size, RO-MAP with JPEG colour,
TUM with colour (PNG and JPEG) at another size than its depth, COLMAP
with JPEG images, and Blender with RGBA PNGs; Replica with RGBA, LA and
16-bit semantic PNGs, and TUM with RGBA, LA, 16-bit grey, palette,
progressive JPEG and Adam7 colour frames, each at its own size and
resized (a real resize of RGBA and LA goes through Pillow's premultiplied
alpha, of 16-bit grey through its 16-bit path). Each is read through
`dqo_map_tpu.data.readers` (PIL), then through
`dqo_map_tpu_torch.data.readers` with `PIL` set to None in `sys.modules`:
every camera's image, depth, semantics, instance, poses, intrinsics,
timestamp and detections must be equal, bit for bit.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from dqo_map_tpu.data import readers as jreaders
from dqo_map_tpu_torch.data import readers

W, H = 40, 30


def _rgbd(rng, colour_path, depth_path, scale, colour_size=(W, H), **opts):
    cw, ch = colour_size
    y, x = np.mgrid[0:ch, 0:cw]
    img = np.stack([(7 * x + 3 * y) % 256, (5 * y) % 256,
                    rng.integers(0, 256, (ch, cw))], -1).astype(np.uint8)
    Image.fromarray(img).save(colour_path, **opts)
    depth = (rng.uniform(0.4, 4.0, (H, W)) * scale).astype(np.uint16)
    Image.fromarray(depth).save(depth_path)


def _replica(root, rng):
    scene = root / "office0"
    os.makedirs(scene / "results")
    os.makedirs(scene / "semantic_colors")
    (root / "cam_params.json").write_text(json.dumps({"camera": {
        "w": W, "h": H, "fx": 30.0, "fy": 31.0, "cx": 19.5, "cy": 14.5,
        "scale": 6553.5}}))
    lines, dets = [], []
    for i in range(4):
        _rgbd(rng, scene / "results" / f"frame{i:06d}.jpg",
              scene / "results" / f"depth{i:06d}.png", 6553.5, quality=90)
        # the last semantic image at another size: resized as PIL does
        size = (W, H) if i < 3 else (2 * W, 2 * H)
        sem = rng.integers(0, 4, (size[1], size[0]))
        palette = np.array([[200, 30, 30], [30, 200, 30], [30, 30, 200],
                            [90, 90, 90]], np.uint8)
        Image.fromarray(palette[sem]).save(
            scene / "semantic_colors" / f"semantic_color{i:06d}.png")
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.02 * i, -0.03 * i]
        lines.append(" ".join(f"{v:.6f}" for v in c2w.reshape(-1)))
        dets.append({"file_name": f"{i}.jpg", "detections": [
            {"category_id": 3, "detection_score": 0.9,
             "bbox": [6.0 + i, 7.0, 30.0, 22.0],
             "ellipse": [18.0, 14.0, 8.0, 5.0, 0.3]},
            {"category_id": 5, "bbox": [1.0, 1.0, 10.0, 10.0]}]})
    (scene / "traj.txt").write_text("\n".join(lines) + "\n")
    (root / "dets.json").write_text(json.dumps(dets))
    return str(scene), dict(use_semantics=True, use_object=True,
                            json_path=str(root / "dets.json"))


def _ours(root, rng):
    for d in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(root / d)
    for i in range(3):
        _rgbd(rng, root / "color" / f"{i}.jpg", root / "depth" / f"{i}.png",
              1000.0, colour_size=(2 * W, 2 * H), quality=95)
        pose = np.eye(4)
        pose[:3, 3] = [0.05 * i, 0.0, 0.01 * i]
        np.savetxt(root / "pose" / f"{i}.txt", pose)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 30.0, 30.0, 20.0, 15.0
    np.savetxt(root / "intrinsic" / "intrinsic_depth.txt", K)
    return str(root), dict(crop_edge=2, scannetpp=True)


def _romap(root, rng):
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    for i in range(3):
        _rgbd(rng, root / "rgb" / f"{i:04d}.jpg",
              root / "depth" / f"{i:04d}.png", 1000.0, quality=80,
              subsampling=1)
    gt = "\n".join(f"{i} 0 {0.05 * i} 0 0 0 0.0998 0.995" for i in range(3))
    (root / "groundtruth.txt").write_text(gt + "\n")
    (root / "camera.json").write_text(json.dumps(
        {"fx": 30.0, "fy": 30.0, "cx": 20.0, "cy": 15.0, "w": W, "h": H,
         "scale": 1000.0}))
    return str(root), {}


def _tum(root, rng):
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb, depth, gt = [], [], []
    for i in range(3):
        t = 100.0 + 0.05 * i
        ext = ".png" if i % 2 else ".jpg"
        # colour at another size than the depth: resized to it
        _rgbd(rng, root / "rgb" / f"{t:.4f}{ext}",
              root / "depth" / f"{t:.4f}.png", 5000.0,
              colour_size=(W + 24, H + 18))
        rgb.append(f"{t:.4f} rgb/{t:.4f}{ext}")
        depth.append(f"{t + 0.003:.4f} depth/{t:.4f}.png")
        gt.append(f"{t:.4f} {0.1 * i} 0 0 0 0 0 1")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth) + "\n")
    (root / "groundtruth.txt").write_text("# gt\n" + "\n".join(gt) + "\n")
    (root / "intrinsics.json").write_text(json.dumps(
        {"fx": 30.0, "fy": 30.0, "cx": 20.0, "cy": 15.0}))
    return str(root), dict(crop_edge=3)


def _colmap(root, rng):
    os.makedirs(root / "images")
    os.makedirs(root / "sparse" / "0")
    lines = []
    for i in range(3):
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"im{i}.jpg",
                                  quality=85)
        lines.append(f"{i + 1} 1 0 0 0 {0.1 * i} 0 0 1 im{i}.jpg\n\n")
    (root / "sparse" / "0" / "cameras.txt").write_text(
        f"1 PINHOLE {2 * W} {2 * H} 60 60 40 30\n")
    (root / "sparse" / "0" / "images.txt").write_text("".join(lines))
    return str(root), {}


def _blender(root, rng):
    os.makedirs(root / "train")
    frames = []
    for i in range(2):
        img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(root / "train" / f"r_{i}.png")
        m = np.eye(4)
        m[:3, 3] = [0.0, 0.1 * i, 2.0]
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": m.tolist()})
    (root / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.69, "frames": frames}))
    return str(root), {}


def _replica_modes(root, rng):
    """Replica whose semantic PNGs are RGBA and LA at the depth's own size
    (read as they are, `[..., :3]` keeping what there is), then RGBA, LA
    and 16-bit grey at twice the size (resized)."""
    path, kwargs = _replica(root, rng)
    sem = root / "office0" / "semantic_colors"
    for i, (mode, scale) in enumerate((("RGBA", 1), ("LA", 1), ("RGBA", 2),
                                       ("LA", 2))):
        ch = len(mode)
        img = rng.integers(0, 256, (H * scale, W * scale, ch)).astype(np.uint8)
        img[..., -1] = rng.choice([0, 255, 7, 128], img.shape[:2])
        Image.fromarray(img, mode).save(sem / f"semantic_color{i:06d}.png")
    grey16 = rng.integers(0, 2 ** 16, (2 * H, 2 * W)).astype(np.uint16)
    Image.fromarray(grey16).save(sem / f"semantic_color{4:06d}.png")
    scene = root / "office0"
    _rgbd(rng, scene / "results" / f"frame{4:06d}.jpg",
          scene / "results" / f"depth{4:06d}.png", 6553.5, quality=90)
    lines = (scene / "traj.txt").read_text().splitlines()
    (scene / "traj.txt").write_text("\n".join(lines + [lines[-1]]) + "\n")
    return path, dict(use_semantics=True)


def _tum_modes(root, rng):
    """TUM whose colour frames are RGBA, LA, 16-bit grey, palette,
    progressive JPEG and Adam7 PNG, each at the depth's size and at
    another size."""
    from torch_fixtures.make_png_fixtures import png_bytes
    path, kwargs = _tum(root, rng)
    rgb_txt, depth_txt, gt_txt = ([], [], [])
    kinds = ("RGBA", "LA", "I;16", "P", "progressive", "adam7")
    for i, (kind, grow) in enumerate((k, g) for k in kinds for g in (0, 1)):
        t = 200.0 + 0.05 * i
        cw, ch = W + 24 * grow, H + 18 * grow
        name = f"rgb/m{i}" + (".jpg" if kind == "progressive" else ".png")
        if kind in ("RGBA", "LA"):
            img = rng.integers(0, 256, (ch, cw, len(kind))).astype(np.uint8)
            img[..., -1] = rng.choice([0, 255, 3, 200], (ch, cw))
            Image.fromarray(img, kind).save(root / name)
        elif kind == "I;16":
            Image.fromarray(rng.integers(0, 2 ** 16, (ch, cw)).astype(
                np.uint16)).save(root / name)
        elif kind == "P":
            if grow:          # PIL resizes a palette image NEAREST: refused
                continue
            img = Image.fromarray(rng.integers(0, 256, (ch, cw, 3)).astype(
                np.uint8)).convert("P")
            img.save(root / name)
        elif kind == "progressive":
            Image.fromarray(rng.integers(0, 256, (ch, cw, 3)).astype(
                np.uint8)).save(root / name, quality=85, progressive=True)
        else:
            (root / name).write_bytes(png_bytes(
                rng.integers(0, 256, (ch, cw, 3)), 8, 2, interlace=True,
                kinds=(0, 1, 2, 3, 4)))
        _rgbd(rng, root / "rgb" / "unused.png", root / f"depth/m{i}.png",
              5000.0)
        rgb_txt.append(f"{t:.4f} {name}")
        depth_txt.append(f"{t + 0.003:.4f} depth/m{i}.png")
        gt_txt.append(f"{t:.4f} {0.01 * i} 0 0 0 0 0 1")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_txt) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth_txt)
                                    + "\n")
    (root / "groundtruth.txt").write_text("# gt\n" + "\n".join(gt_txt)
                                          + "\n")
    return path, kwargs


LAYOUTS = {"replica": (_replica, "read_replica"),
           "replica_modes": (_replica_modes, "read_replica"),
           "tum_modes": (_tum_modes, "read_tum"),
           "ours": (_ours, "read_ours"),
           "romap": (_romap, "read_romap"),
           "tum": (_tum, "read_tum"),
           "colmap": (_colmap, "read_colmap"),
           "blender": (_blender, "read_blender")}
FIELDS = ("uid", "fx", "fy", "cx", "cy", "width", "height", "timestamp",
          "depth_scale")
ARRAYS = ("c2w", "pose_gt", "image", "depth", "semantics", "instance")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_matches_jax_without_pil(tmp_path, monkeypatch, layout):
    make, fn = LAYOUTS[layout]
    path, kwargs = make(tmp_path, np.random.default_rng(len(layout)))
    want = getattr(jreaders, fn)(path, **kwargs)
    monkeypatch.setitem(sys.modules, "PIL", None)            # no PIL
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = getattr(readers, fn)(path, **kwargs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        for f in ARRAYS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, f
                assert np.array_equal(a, b), f
        assert g.detections == w.detections
    if layout == "replica":
        assert got[0].semantics is not None and got[0].detections
    if layout == "replica_modes":
        # JAX's `[..., :3]` keeps what an RGBA or LA image has, and cuts a
        # grey image's columns
        assert [g.semantics.shape for g in got] == [
            (H, W, 3), (H, W, 2), (H, W, 3), (H, W, 2), (H, 3)]
    if layout == "tum_modes":
        assert len(got) == 11 and got[0].image.shape[-1] == 4
    if layout in ("replica", "ours", "romap", "tum"):
        assert got[0].depth is not None and got[0].image.ndim == 3


def test_rgba_frame_at_its_own_size_reads_as_jax(tmp_path, monkeypatch):
    """A 6x8 RGBA PNG loaded at (8, 6), its own size, gives (6, 8, 4) in
    both packages (Pillow's resize returns a copy there)."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (6, 8, 4)).astype(np.uint8)
    path = str(tmp_path / "sem.png")
    Image.fromarray(img, "RGBA").save(path)
    want = jreaders._load_image(path, (8, 6))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = readers._load_image(path, (8, 6))
    assert want.shape == got.shape == (6, 8, 4)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_readers_refuse_other_formats(tmp_path):
    bad = tmp_path / "frame.gif"
    bad.write_bytes(b"GIF89a" + bytes(16))
    with pytest.raises(ValueError, match="frame.gif: neither a PNG nor a "
                                         "JPEG"):
        readers._load_image(str(bad))
    with pytest.raises(ValueError, match="frame.gif"):
        readers._load_depth(str(bad), 1000.0)


def _kind_file(path, kind, rng):
    """A 24x36 frame of each image kind whose reading or resizing PIL does
    its own way: palette and 1-bit PNGs (NEAREST), CMYK and YCCK JPEGs
    (4 inverted bands, resized band by band), and the JPEG codings the
    decoder reads besides Huffman: arithmetic, progressive with bits left
    unsent (smoothed), lossless."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "torch_fixtures"))
    import jpeg_writers as jw
    y, x = np.mgrid[0:24, 0:36]
    rgb = np.stack([(7 * x + 3 * y) % 256, (5 * y) % 256,
                    rng.integers(0, 256, (24, 36))], -1).astype(np.uint8)
    if kind == "palette":
        im = Image.fromarray(rng.integers(0, 16, (24, 36)).astype(np.uint8),
                             "P")
        im.putpalette(list(rng.integers(0, 256, 48)))
        im.save(path)
    elif kind == "bilevel":
        Image.fromarray(rng.integers(0, 2, (24, 36)).astype(bool)).save(path)
    elif kind == "cmyk":
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1), "CMYK").save(
            path, quality=85)
    else:
        cmyk = np.concatenate([rgb, 255 - rgb[..., 1:2]], -1)
        data = {
            "ycck": lambda: jw.write_arithmetic(jw.Frame(cmyk, "YCCK", 80)),
            "arithmetic": lambda: jw.write_arithmetic(jw.Frame(rgb), [
                ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 9, 0, 0),
                ((0, 1, 2), 0, 0, 1, 0)]),
            "unrefined": lambda: jw.write_progressive_huffman(
                jw.Frame(rgb, "YCbCr", 60), [((0, 1, 2), 0, 0, 0, 0),
                                             ((0,), 1, 5, 0, 1)]),
            "lossless": lambda: jw.write_lossless(rgb, 7, 1, "RGB"),
        }[kind]()
        path.write_bytes(data)


@pytest.mark.parametrize("kind", ["palette", "bilevel", "cmyk", "ycck",
                                  "arithmetic", "unrefined", "lossless"])
def test_load_image_reads_each_kind_as_jax(tmp_path, monkeypatch, kind):
    path = tmp_path / ("f.png" if kind in ("palette", "bilevel") else "f.jpg")
    _kind_file(path, kind, np.random.default_rng(len(kind)))
    sizes = (None, (36, 24), (20, 13), (50, 31))
    want = [jreaders._load_image(str(path), s) for s in sizes]
    monkeypatch.setitem(sys.modules, "PIL", None)            # no PIL
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for s, w in zip(sizes, want):
        got = readers._load_image(str(path), s)
        assert got.dtype == w.dtype and got.shape == w.shape, s
        assert np.array_equal(got, w), s
