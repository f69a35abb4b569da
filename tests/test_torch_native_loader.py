"""The port's PNG reader (`utils/png.py::read_png`), its dataset readers'
image loading, and its binding of the native frame loader
(`data/native_loader.py`, built from `runtime/frame_loader.cc`), on the
CPU.

- `read_png` against PIL, exactly: 8- and 16-bit grey, grey-alpha, RGB
  and RGBA, each with every row filter (none, sub, up, average, Paeth)
  and with the five mixed row by row; PIL keeps the high byte of 16-bit
  colour samples and turns 16-bit grey-alpha into RGBA, and so does
  `read_png`. Palette files at 1, 2, 4 and 8 bits (the indices, with and
  without tRNS), 1-bit grey (bool), 2- and 4-bit grey (scaled), and
  Adam7 interlacing of every colour type and bit depth; the committed
  PNG fixtures' hashes, modes and (palette, 1-bit) NEAREST resizes. A
  bit depth a colour type does not allow or an unknown colour type
  raises, as in PIL; damaged files are read, or refused, as PIL reads or
  refuses them (CRCs before the image data, the zlib stream inflated no
  further than the rows). The PNGs are written
  here by small encoders that apply the filters the PNG specification
  defines (`torch_fixtures/make_png_fixtures.py::png_bytes`).
- The readers decode PNG and JPEG frames and resize them without PIL
  (PIL hidden from the import), exactly as PIL does.
- The native loader: its own g++ build into `_build/`, cached by hash;
  a failed build raising with the compiler's output; `decode_depth_png`
  and `NativeDepthLoader` (prefetch, get, evict) against the JAX
  package's binding and against PIL, exactly, on 16-bit depth PNGs; a
  file that does not decode giving None and `IOError`.
"""

import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dqo_map_tpu.data import native_loader as jloader
from dqo_map_tpu_torch.data import native_loader as loader
from dqo_map_tpu_torch.data import readers
from dqo_map_tpu_torch.utils.png import read_png
from dqo_map_tpu_torch.utils.resize import resize_like_pil
from torch_fixtures.make_png_fixtures import digest, png_bytes, resize_size

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
    got, ref = read_png(str(path))[0], np.asarray(Image.open(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    if bits == 8 or colour_type == 0:
        assert np.array_equal(got, img)          # the samples themselves


def _header_swapped(data: bytes, bits: int = None, colour_type: int = None,
                    interlace: int = None) -> bytes:
    """The PNG with its IHDR's bit depth, colour type or interlace method
    replaced (and the chunk's CRC made anew)."""
    W, H, b, c, comp, filt, lace = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", W, H, b if bits is None else bits,
                       c if colour_type is None else colour_type, comp, filt,
                       lace if interlace is None else interlace)
    return data[:8] + _chunk(b"IHDR", body) + data[33:]


REFUSED_PNG = {
    # RGB at 4 bits: no such PNG
    "bad_depth": (lambda d: _header_swapped(d, bits=4),
                  "4 bits for colour type 2"),
    "unknown_type": (lambda d: _header_swapped(d, colour_type=5),
                     "unknown colour type 5"),
    # any method but 0 is Adam7 to PIL: the plain rows fall short
    "interlace_method": (lambda d: _header_swapped(d, interlace=2),
                         "truncated PNG data"),
    "not_png": (lambda d: b"not a png", "not a PNG"),
    # 20000 x 20000: past twice Image.MAX_IMAGE_PIXELS
    "decompression_bomb": (lambda d: d[:8] + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 20000, 20000, 8, 2, 0, 0, 0)) + d[33:],
        "decompression-bomb"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED_PNG))
def test_read_png_refuses_what_it_does_not_read(tmp_path, kind):
    path = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    make, why = REFUSED_PNG[kind]
    path.write_bytes(make(path.read_bytes()))
    with pytest.raises((OSError, SyntaxError, Image.DecompressionBombError)):
        np.asarray(Image.open(path))
    with pytest.raises(ValueError, match=why):
        read_png(str(path))


# (colour type, bits) that PIL reads in modes other than the 8- and 16-bit
# samples above: palette (`P`, the indices), 1-bit grey (`1`, bool), 2-
# and 4-bit grey (`L`, scaled)
LOW = [(3, 1), (3, 2), (3, 4), (3, 8), (0, 1), (0, 2), (0, 4)]


@pytest.mark.parametrize("trns", [False, True], ids=["opaque", "trns"])
@pytest.mark.parametrize("ct_bits", LOW, ids=lambda c: f"type{c[0]}_{c[1]}bit")
def test_read_png_palette_and_low_bits_match_pil(tmp_path, ct_bits, trns):
    ct, bits = ct_bits
    rng = np.random.default_rng(ct * 10 + bits)
    path = tmp_path / "t.png"
    for H, W in ((1, 1), (3, 5), (9, 13), (17, 10)):
        for interlace in (False, True):
            n = min(2 ** bits, 200) if ct == 3 else 0
            img = rng.integers(0, n or 2 ** bits, (H, W))
            pal = rng.integers(0, 256, (n, 3)) if ct == 3 else None
            t = None
            if trns:
                t = (bytes(rng.integers(0, 256, max(1, n // 2)).astype(
                    np.uint8)) if ct == 3 else int(img[0, 0]).to_bytes(2, "big"))
            path.write_bytes(png_bytes(img, bits, ct, interlace,
                                       (0, 1, 2, 3, 4), pal, t))
            got, ref = read_png(str(path))[0], np.asarray(Image.open(path))
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert np.array_equal(got, ref), (H, W, interlace)


@pytest.mark.parametrize("colour_type", [0, 2, 4, 6],
                         ids=["grey", "rgb", "grey_alpha", "rgba"])
@pytest.mark.parametrize("bits", [8, 16])
def test_read_png_adam7_matches_pil(tmp_path, bits, colour_type):
    """Adam7: seven passes, each its own filtered scanlines; sizes that
    leave some passes empty."""
    rng = np.random.default_rng(bits + colour_type)
    path = tmp_path / "i.png"
    for H, W in ((1, 1), (2, 3), (5, 4), (8, 8), (19, 23)):
        img = _image(rng, bits, colour_type, H, W)
        path.write_bytes(png_bytes(img, bits, colour_type, True,
                                   (0, 1, 2, 3, 4)))
        got, ref = read_png(str(path))[0], np.asarray(Image.open(path))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref), (H, W)


PNG_FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "png"
PNG_HASHES = json.loads((PNG_FIXTURES / "hashes.json").read_text())


@pytest.mark.parametrize("name", sorted(PNG_HASHES))
def test_png_fixture_hashes_are_pils(name):
    """The committed PNG fixtures (`make_png_fixtures.py`), which
    `chip_smoke.py` holds `read_png` to on the card, against PIL."""
    path = PNG_FIXTURES / name
    ref = np.asarray(Image.open(path))
    want = PNG_HASHES[name]
    assert list(ref.shape) == want["shape"] and str(ref.dtype) == want["dtype"]
    assert digest(ref) == want["sha256"]
    got, mode = read_png(str(path))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert mode == Image.open(path).mode == want["mode"]
    assert ("resized" in want) == (mode in ("P", "1"))
    if "resized" in want:                  # NEAREST, as Pillow resizes
        size = resize_size(*got.shape[::-1])
        small = np.asarray(Image.open(path).resize(size))
        assert digest(small) == want["resized"]["sha256"]
        assert np.array_equal(resize_like_pil(got, size, mode), small)


def test_png_fixtures_are_small():
    files = sorted(PNG_FIXTURES.glob("*.png"))
    assert {f.name for f in files} == set(PNG_HASHES)
    assert sum(f.stat().st_size for f in files) < 20_000


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
    want_small = _pil_load_image(tmp_path / "frame.png", (10, 6))
    want_jpg_small = _pil_load_image(tmp_path / "frame.jpg", (10, 6))

    monkeypatch.setitem(sys.modules, "PIL", None)            # no PIL
    got = readers._load_depth(str(tmp_path / "depth.png"), 6553.5)
    assert got.dtype == np.float32 and np.array_equal(got, want_depth)
    for size in ((20, 12), None):
        got = readers._load_image(str(tmp_path / "frame.png"), size)
        assert np.array_equal(got, want_colour)
    # the JPEG and the resize give PIL's arrays without PIL
    got_jpg = readers._load_image(str(tmp_path / "frame.jpg"), (20, 12))
    assert got_jpg.dtype == np.float32 and np.array_equal(got_jpg, want_jpg)
    got = readers._load_image(str(tmp_path / "frame.png"), (10, 6))
    assert got.shape == (6, 10, 3) and np.array_equal(got, want_small)
    got = readers._load_image(str(tmp_path / "frame.jpg"), (10, 6))
    assert np.array_equal(got, want_jpg_small)


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


def _png_image(rng, mode):
    shape = {"RGB": (20, 30, 3), "LA": (20, 30, 2)}.get(mode, (20, 30))
    top, dt = (65536, np.uint16) if mode == "I;16" else (256, np.uint8)
    arr = rng.integers(0, 16 if mode == "P" else top, shape).astype(dt)
    im = Image.fromarray(arr, mode if mode in ("P", "LA") else None)
    if mode == "P":
        im.putpalette(list(range(48)))
    return im


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "I;16", "LA"])
def test_read_damaged_png_matches_pil(tmp_path, mode):
    """PNGs damaged at random, read as PIL reads them: the chunks before
    the image data checked (type, length, CRC), the IDAT chunks' CRCs
    unread, no more of the zlib stream inflated than the rows need (a
    broken checksum or extra data past them unread), nothing after the
    IDAT chunks read. Where PIL decodes a file the port gives its array,
    where PIL refuses it the port raises."""
    rng = np.random.default_rng(len(mode))
    buf = io.BytesIO()
    _png_image(rng, mode).save(buf, "PNG")
    data = buf.getvalue()
    at = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[at:at + 4])[0]
    z, head, tail = data[at + 8:at + 8 + n], data[:at], data[at + 12 + n:]
    path = tmp_path / "d.png"
    outcomes = set()
    for trial in range(48):
        zz, kind = bytearray(z), trial % 8
        if kind == 0:
            zz[-1 - int(rng.integers(0, 4))] ^= 0xFF        # the checksum
        elif kind == 1:
            zz[int(rng.integers(2, len(zz)))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            zz = zz[:int(rng.integers(1, len(zz)))]
        elif kind == 3:
            zz += bytes(rng.integers(0, 256, 5).astype(np.uint8))
        cut = int(rng.integers(1, len(zz)))
        body = head + _chunk(b"IDAT", bytes(zz[:cut])) + \
            _chunk(b"IDAT", bytes(zz[cut:]))
        if kind == 4:
            body += tail[:int(rng.integers(0, len(tail)))]
        elif kind == 5:                      # a bad CRC after the data
            body += _chunk(b"tEXt", b"a\0b")[:-1] + b"x" + tail
        elif kind == 6:                      # and before it
            body = body[:8] + _chunk(b"tEXt", b"a\0b")[:-1] + b"x" + \
                body[8:] + tail
        elif kind == 7:                      # a byte changed anywhere
            body = bytearray(body + tail)
            body[int(rng.integers(8, len(body)))] = int(rng.integers(0, 256))
            body = bytes(body)
        else:
            body += tail
        path.write_bytes(body)
        try:
            ref = np.asarray(Image.open(path))
        except (OSError, SyntaxError, ValueError):
            with pytest.raises(ValueError, match="d.png: "):
                read_png(str(path))
            outcomes.add("refused")
            continue
        got = read_png(str(path))[0]
        assert got.dtype == ref.dtype and np.array_equal(got, ref), trial
        outcomes.add("read")
    assert outcomes == {"read", "refused"}
