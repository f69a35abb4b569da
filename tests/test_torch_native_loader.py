"""The port's PNG reader (`utils/png.py::read_png`), its dataset readers'
image loading, and its binding of the native frame loader
(`data/native_loader.py`, built from `runtime/frame_loader.cc`), on the
CPU.

- `read_png` against PIL, exactly: 8- and 16-bit grey, grey-alpha, RGB
  and RGBA, each with every row filter (none, sub, up, average, Paeth)
  and with the five mixed row by row; PIL keeps the high byte of 16-bit
  colour samples and turns 16-bit grey-alpha into RGBA, and so does
  `read_png`. The PNGs are written here by a small encoder that applies
  the filters the PNG specification defines.
- The readers decode PNG frames without PIL (PIL hidden from the
  import), exactly as they did through PIL; a JPEG frame or a resize
  still goes through PIL, and without it raises an `ImportError` that
  names the file.
- The native loader: its own g++ build into `_build/`, cached by hash;
  a failed build raising with the compiler's output; `decode_depth_png`
  and `NativeDepthLoader` (prefetch, get, evict) against the JAX
  package's binding and against PIL, exactly, on 16-bit depth PNGs; a
  file that does not decode giving None and `IOError`.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from dqo_map_tpu.data import native_loader as jloader
from dqo_map_tpu_torch.data import native_loader as loader
from dqo_map_tpu_torch.data import readers
from dqo_map_tpu_torch.utils.png import read_png

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def _filtered(rows: np.ndarray, kinds, bpp: int) -> np.ndarray:
    """The PNG scanlines of (H, stride) bytes, row y filtered with
    kinds[y % len(kinds)] (PNG specification, section 9)."""
    H, S = rows.shape
    r = rows.astype(np.int16)
    out = np.zeros((H, S + 1), np.uint8)
    for y in range(H):
        k = kinds[y % len(kinds)]
        b = r[y - 1] if y else np.zeros(S, np.int16)
        a = np.concatenate([np.zeros(bpp, np.int16), r[y, :-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int16), b[:-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (np.zeros_like(a), a, b, (a + b) >> 1, paeth)[k]
        out[y, 0] = k
        out[y, 1:] = (r[y] - pred) & 0xFF
    return out


def write_test_png(path, img: np.ndarray, bits: int, colour_type: int,
                   kinds=(0,)):
    H, W = img.shape[:2]
    bpp = CHANNELS[colour_type] * bits // 8
    rows = (img.astype(">u2").reshape(H, -1).view(np.uint8) if bits == 16
            else img.astype(np.uint8).reshape(H, -1))
    raw = _filtered(rows, kinds, bpp)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, bits,
                                            colour_type, 0, 0, 0)))
        # two IDAT chunks: a decoder must join them
        data = zlib.compress(raw.tobytes())
        f.write(_chunk(b"IDAT", data[:len(data) // 2]))
        f.write(_chunk(b"IDAT", data[len(data) // 2:]))
        f.write(_chunk(b"IEND", b""))


def _image(rng, bits, colour_type, H=9, W=13):
    ch = CHANNELS[colour_type]
    img = rng.integers(0, 2 ** bits, (H, W, ch))
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("colour_type", [0, 2, 4, 6],
                         ids=["grey", "rgb", "grey_alpha", "rgba"])
@pytest.mark.parametrize("bits", [8, 16])
def test_read_png_matches_pil(tmp_path, bits, colour_type, kinds):
    rng = np.random.default_rng(bits * 10 + colour_type)
    img = _image(rng, bits, colour_type)
    path = tmp_path / "t.png"
    write_test_png(path, img, bits, colour_type, kinds)
    got, ref = read_png(str(path)), np.asarray(Image.open(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    if bits == 8 or colour_type == 0:
        assert np.array_equal(got, img)          # the samples themselves


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    path = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(path))
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "x.png"))


def _pil_load_image(path, size=None):
    """The readers' image loading as it was, through PIL."""
    img = Image.open(path)
    if size is not None:
        img = img.resize(size)
    return np.asarray(img, np.float32) / 255.0


def test_readers_decode_png_frames_without_pil(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    depth = rng.integers(0, 2 ** 16, (12, 20)).astype(np.uint16)
    Image.fromarray(depth).save(tmp_path / "depth.png")
    colour = rng.integers(0, 256, (12, 20, 3)).astype(np.uint8)
    Image.fromarray(colour).save(tmp_path / "frame.png")
    Image.fromarray(colour).save(tmp_path / "frame.jpg")
    want_depth = np.asarray(Image.open(tmp_path / "depth.png"),
                            np.float32) / 6553.5
    want_colour = _pil_load_image(tmp_path / "frame.png", (20, 12))
    want_jpg = _pil_load_image(tmp_path / "frame.jpg", (20, 12))
    got_jpg = readers._load_image(str(tmp_path / "frame.jpg"), (20, 12))
    assert np.array_equal(got_jpg, want_jpg)                 # PIL's
    assert readers._load_image(str(tmp_path / "frame.png"),
                               (10, 6)).shape == (6, 10, 3)  # PIL's resize

    monkeypatch.setitem(sys.modules, "PIL", None)            # no PIL
    got = readers._load_depth(str(tmp_path / "depth.png"), 6553.5)
    assert got.dtype == np.float32 and np.array_equal(got, want_depth)
    for size in ((20, 12), None):
        got = readers._load_image(str(tmp_path / "frame.png"), size)
        assert np.array_equal(got, want_colour)
    with pytest.raises(ImportError, match="frame.jpg: reading a JPEG"):
        readers._load_image(str(tmp_path / "frame.jpg"), (20, 12))
    with pytest.raises(ImportError, match="frame.png: resizing a 20x12 "
                                          "frame to \\(10, 6\\) needs PIL"):
        readers._load_image(str(tmp_path / "frame.png"), (10, 6))


@pytest.fixture(scope="module")
def depth_pngs(tmp_path_factory):
    """Five 16-bit depth PNGs (PIL's and the filter encoder's) and a file
    that is not a PNG."""
    d = tmp_path_factory.mktemp("depth")
    rng = np.random.default_rng(11)
    paths, imgs = [], []
    for i in range(5):
        img = rng.integers(0, 2 ** 16, (30 + i, 40)).astype(np.uint16)
        p = d / f"depth{i}.png"
        if i % 2:
            write_test_png(p, img, 16, 0, (0, 1, 2, 3, 4))
        else:
            Image.fromarray(img).save(p)
        paths.append(str(p))
        imgs.append(img)
    bad = d / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n garbage")
    return paths, imgs, str(bad)


def test_native_build_is_cached_and_failures_raise(tmp_path, monkeypatch):
    path = loader.build_library()
    assert path.parent == loader.BUILD_DIR and path.exists()
    assert path.name.startswith("libframe_loader_")
    assert loader.build_library() == path                    # cached
    assert loader.native_available()
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SOURCE", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        loader.build_library()
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        loader.build_library()


def test_decode_depth_png_matches_jax_and_pil(depth_pngs):
    paths, imgs, bad = depth_pngs
    for p, img in zip(paths, imgs):
        got = loader.decode_depth_png(p)
        assert got.dtype == np.uint16
        assert np.array_equal(got, img)
        assert np.array_equal(got, jloader.decode_depth_png(p))
        assert np.array_equal(got, np.asarray(Image.open(p)))
    assert loader.decode_depth_png(bad) is None
    assert jloader.decode_depth_png(bad) is None
    assert loader.decode_depth_png(paths[0], max_pixels=100) is None


def test_native_depth_loader_matches_jax(depth_pngs):
    paths, imgs, bad = depth_pngs
    jl = jloader.NativeDepthLoader(paths + [bad], workers=2, cache_cap=3)
    with loader.NativeDepthLoader(paths + [bad], workers=2,
                                  cache_cap=3) as pl:
        assert len(pl) == 6
        pl.prefetch(0, 3)
        jl.prefetch(0, 3)
        for i in (0, 1, 2, 4, 3):
            got = pl.get(i)
            assert np.array_equal(got, imgs[i])
            assert np.array_equal(got, jl.get(i))
        pl.evict_below(4)
        jl.evict_below(4)
        # an evicted frame is decoded again on demand
        assert np.array_equal(pl.get(1), imgs[1])
        with pytest.raises(IOError, match="frame 5"):
            pl.get(5)
        with pytest.raises(IOError):
            jl.get(5)
        with pytest.raises(IndexError):
            pl.get(6)
        with pytest.raises(IndexError):
            pl.prefetch(-1, 2)
    with pytest.raises(ValueError, match="closed"):
        pl.get(0)
    jl.close()
