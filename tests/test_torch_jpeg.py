"""The port's JPEG decoder (`utils/jpeg.py::read_jpeg`, built from
`csrc/jpeg_decode.cc`), its encoder (`encode_jpeg`, `write_jpeg`) and
`utils/resize.py::resize_like_pil`, against PIL, exactly, on the CPU.

- `read_jpeg` gives `np.asarray(Image.open(path))` bit for bit: sizes
  1x1 to 1200x680, PIL's subsampling 0 (4:4:4), 1 (4:2:2), 2 (4:2:0) and
  mode `L`, qualities 5 to 100, noise and smooth content; optimised
  Huffman tables and restart markers (by blocks and by rows); luma
  sampling factors PIL does not write (4:4:0, 4:1:1 and others, through
  the encoder's `factors`); an Adobe file of colour transform 1.
- Progressive files (PIL's `progressive=True`: grey, 4:4:4, 4:2:2, 4:2:0,
  optimised tables, restart markers, sizes 1x1 to 1200x680) and RGB ones
  (Adobe transform 0, or unmarked with component ids 'R', 'G', 'B').
- The kinds PIL decodes but cannot write, from
  `torch_fixtures/jpeg_writers.py`, PIL the judge of each file:
  arithmetic coding (every colour kind and sampling, restarts, DAC
  conditioning), progressive files of chosen scan scripts (Huffman and
  arithmetic) cut after every scan, whose unsent bits libjpeg smooths,
  and PIL's own progressive files cut likewise; CMYK and YCCK (and PIL's
  CMYK files); lossless files of every predictor. Files damaged at
  random, read as libjpeg recovers them; a sequential file without
  Huffman tables; bytes and stray markers between segments.
- What PIL refuses the port refuses, naming the cause, and each case
  pins that PIL refuses it: 12-bit and hierarchical files (real ones and
  relabelled), lossless arithmetic or colour-converted, arithmetic data
  past the file's first 65536 bytes, 2 components, the JPG marker, bad
  scan parameters, truncated files. The files the port once refused and
  PIL decodes read as PIL reads them.
- `encode_jpeg` writes PIL's file byte for byte (`Image.save(f, "JPEG",
  quality=q)`, 4:2:0 and grey) on noise and gradients, at sizes that are
  not multiples of 16 and at qualities 5 to 100; PIL decodes
  `write_jpeg`'s files to the arrays `read_jpeg` gives, and a synthetic
  room frame at 1200x680, quality 95, 4:2:0, is above 40 dB.
- `resize_like_pil` gives `Image.resize(size)` bit for bit for `L`,
  `RGB`, `RGBA`, `LA`, `I;16` and `CMYK` (BICUBIC) and `P` and `1`
  (NEAREST): shrink, grow, one axis, the same size (a copy, whatever the
  image).
- The committed fixtures' hashes and modes (`tests/torch_fixtures/jpeg/`,
  which `chip_smoke.py` holds the decoder to) are PIL's.
- The decoder's g++ build is cached in `_build/`, and a failed build
  raises.
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dqo_map_tpu_torch.utils import jpeg
from dqo_map_tpu_torch.utils.jpeg import encode_jpeg, read_jpeg, write_jpeg
from dqo_map_tpu_torch.utils.resize import resize_like_pil

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "jpeg"
sys.path.insert(0, str(FIXTURES.parent))
import jpeg_writers as jw  # noqa: E402
SIZES = [(1, 1), (8, 8), (15, 17), (33, 65), (161, 97), (1200, 680)]
QUALITIES = (5, 50, 75, 95, 100)


def _content(rng, H, W, kind):
    if kind == "noise":
        return rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 11.0 + y / 29.0),
                    128 + 90 * np.cos(y / 13.0),
                    (2 * x + y) % 256], -1)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _pil_jpeg(path, img, **opts):
    Image.fromarray(img).save(path, "JPEG", **opts)
    return np.asarray(Image.open(path))


def _same(got, ref):
    return got.dtype == ref.dtype and got.shape == ref.shape and \
        np.array_equal(got, ref)


@pytest.mark.parametrize("sub", [0, 1, 2, "L"],
                         ids=["444", "422", "420", "grey"])
@pytest.mark.parametrize("W,H", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_read_jpeg_matches_pil(tmp_path, W, H, sub):
    rng = np.random.default_rng(W * 1000 + H)
    path = tmp_path / "f.jpg"
    for kind in ("noise", "smooth"):
        img = _content(rng, H, W, kind)
        if sub == "L":
            img = img[..., 1]
        for q in QUALITIES:
            opts = dict(quality=q) if sub == "L" else dict(quality=q,
                                                           subsampling=sub)
            ref = _pil_jpeg(path, img, **opts)
            assert _same(read_jpeg(path)[0], ref), (kind, q)


@pytest.mark.parametrize("opts", [
    dict(optimize=True), dict(restart_marker_blocks=1),
    dict(restart_marker_blocks=5), dict(restart_marker_rows=1),
    dict(restart_marker_rows=3),
    dict(optimize=True, restart_marker_blocks=2)],
    ids=["optimize", "rst_blocks1", "rst_blocks5", "rst_rows1", "rst_rows3",
         "optimize_rst"])
@pytest.mark.parametrize("sub", [0, 1, 2, "L"],
                         ids=["444", "422", "420", "grey"])
def test_read_jpeg_tables_and_restarts_match_pil(tmp_path, sub, opts):
    rng = np.random.default_rng(7)
    path = tmp_path / "f.jpg"
    for H, W in ((97, 161), (33, 65)):
        for kind in ("noise", "smooth"):
            img = _content(rng, H, W, kind)
            if sub == "L":
                img = img[..., 0]
            else:
                opts = dict(opts, subsampling=sub)
            for q in (30, 90):
                ref = _pil_jpeg(path, img, quality=q, **opts)
                assert _same(read_jpeg(path)[0], ref), (H, W, kind, q)


@pytest.mark.parametrize("factors", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                     (1, 4), (4, 2), (2, 4)],
                         ids=lambda f: f"h{f[0]}v{f[1]}")
def test_read_jpeg_sampling_factors_match_pil(tmp_path, factors):
    """4:4:0 (h1v2, libjpeg's h1v2 fancy upsampling) and the generic
    integral factors PIL cannot write, from the encoder's `factors`."""
    rng = np.random.default_rng(factors[0] * 10 + factors[1])
    path = tmp_path / "f.jpg"
    for H, W in ((1, 1), (2, 3), (3, 5), (17, 33), (97, 161)):
        for kind in ("noise", "smooth"):
            img = _content(rng, H, W, kind)
            path.write_bytes(encode_jpeg(img, 80, factors=factors))
            assert _same(read_jpeg(path)[0], np.asarray(Image.open(path))), \
                (H, W, kind)


def _replace_app0(data: bytes, app: bytes) -> bytes:
    end = 4 + int.from_bytes(data[4:6], "big")
    return data[:2] + app + data[end:]


def _adobe(transform: int) -> bytes:
    body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    return b"\xff\xee" + (len(body) + 2).to_bytes(2, "big") + body


def test_read_jpeg_adobe_ycbcr_matches_pil(tmp_path):
    rng = np.random.default_rng(3)
    img = _content(rng, 45, 71, "noise")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85)
    path = tmp_path / "adobe.jpg"
    path.write_bytes(_replace_app0(buf.getvalue(), _adobe(1)))
    assert _same(read_jpeg(path)[0], np.asarray(Image.open(path)))
    # no JFIF and no Adobe segment: YCbCr by the component ids 1, 2, 3
    path.write_bytes(_replace_app0(buf.getvalue(), b""))
    assert _same(read_jpeg(path)[0], np.asarray(Image.open(path)))


def _ids_rgb(data: bytes) -> bytes:
    """A baseline file of 3 components with its component ids 1, 2, 3
    renamed 'R', 'G', 'B' in the frame and the scan header, and no JFIF
    segment: libjpeg reads it as RGB."""
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    out = bytearray(data)
    for at, stride in ((sof + 10, 3), (sos + 5, 2)):
        out[at:at + 3 * stride:stride] = b"RGB"
    return _replace_app0(bytes(out), b"")


PROGRESSIVE_OPTS = {"plain": {}, "optimize": dict(optimize=True),
                    "rst_blocks3": dict(restart_marker_blocks=3),
                    "rst_rows1": dict(restart_marker_rows=1)}


@pytest.mark.parametrize("opts", sorted(PROGRESSIVE_OPTS))
@pytest.mark.parametrize("sub", [0, 1, 2, "L"],
                         ids=["444", "422", "420", "grey"])
def test_read_progressive_jpeg_matches_pil(tmp_path, sub, opts):
    """PIL's progressive files (libjpeg's simple progression: the DC and AC
    first scans, then the refinements) decode to PIL's arrays."""
    rng = np.random.default_rng(31)
    path = tmp_path / "p.jpg"
    for H, W in ((1, 1), (15, 17), (33, 65), (97, 161)):
        for kind in ("noise", "smooth"):
            img = _content(rng, H, W, kind)
            o = dict(PROGRESSIVE_OPTS[opts], progressive=True)
            if sub == "L":
                img = img[..., 2]
            else:
                o["subsampling"] = sub
            for q in (5, 75, 95, 100):
                ref = _pil_jpeg(path, img, quality=q, **o)
                assert _same(read_jpeg(path)[0], ref), (H, W, kind, q)


def test_read_progressive_jpeg_at_office0_scale(tmp_path):
    rng = np.random.default_rng(32)
    path = tmp_path / "p.jpg"
    img = _content(rng, 680, 1200, "smooth")
    for sub in (0, 2):
        ref = _pil_jpeg(path, img, quality=90, subsampling=sub,
                        progressive=True)
        assert _same(read_jpeg(path)[0], ref)


@pytest.mark.parametrize("sub", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("how", ["adobe0", "ids_rgb"])
def test_read_jpeg_rgb_matches_pil(tmp_path, how, sub):
    """RGB files, no colour conversion: an Adobe segment of transform 0, or
    no marker and component ids 'R', 'G', 'B' (jdapimin.c's guess); an
    Adobe transform libjpeg does not know reads as YCbCr."""
    rng = np.random.default_rng(sub)
    path = tmp_path / "rgb.jpg"
    for kind in ("noise", "smooth"):
        img = _content(rng, 45, 71, kind)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=sub)
        files = ([_replace_app0(buf.getvalue(), _adobe(t)) for t in (0, 2)]
                 if how == "adobe0" else [_ids_rgb(buf.getvalue())])
        for data in files:
            path.write_bytes(data)
            assert _same(read_jpeg(path)[0], np.asarray(Image.open(path)))


def _bad_files():
    """Files the port once refused or refuses: {name: (bytes, the cause
    the port names, or None where PIL decodes the file)}."""
    rng = np.random.default_rng(4)
    img = _content(rng, 40, 56, "noise")

    def save(**opts):
        buf = io.BytesIO()
        Image.fromarray(img).convert(opts.pop("mode", "RGB")).save(
            buf, "JPEG", **opts)
        return buf.getvalue()

    base = save(quality=80)
    sof = base.index(b"\xff\xc0")
    sos = base.index(b"\xff\xda")
    prog = save(quality=80, progressive=True)
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    # the DC scan's Se (0 in a DC scan) made 5
    bad_scan = bytearray(prog)
    bad_scan[scans[0] + 4 + 2 * prog[scans[0] + 4] + 2] = 5
    grey = img[..., 0]
    lossless = jw.write_lossless(grey[:20, :24], 1)
    small = jw.write_arithmetic(jw.Frame(img[:16, :16], "YCbCr", 50))
    at = small.index(b"\xff\xda")
    pad = 65536 - at - 20           # the scan's data straddle byte 65536
    two = bytearray(base)           # two components named in the frame
    two[sof + 9] = 2
    return {
        # the file cut after its first two scans: bits left unsent
        "progressive_unrefined": (prog[:scans[2]] + b"\xff\xd9", None),
        "progressive_bad_scan": (bytes(bad_scan),
                                 "bad progressive scan parameters"),
        "hierarchical": (base[:sof] + b"\xff\xc5" + base[sof + 2:],
                         "hierarchical \\(differential\\) frame \\(SOF5"),
        # a baseline file read as arithmetic-coded: libjpeg decodes it
        "arithmetic": (base[:sof] + b"\xff\xc9" + base[sof + 2:], None),
        "lossless": (base[:sof] + b"\xff\xc3" + base[sof + 2:],
                     "bad lossless scan parameters"),
        "12bit": (base[:sof + 4] + bytes([12]) + base[sof + 5:],
                  "12-bit samples"),
        "cmyk": (save(quality=80, mode="CMYK"), None),
        "truncated": (base[:len(base) // 2], "truncated"),
        "no_eoi": (base[:-2], "truncated"),
        # the scan cut by EOI: zeros from there, as libjpeg reads it
        "marker_in_scan": (base[:sos + 40] + b"\xff\xd9", None),
        "not_jpeg": (b"GIF89a" + bytes(20), "not a JPEG"),
        "12bit_file": (jw.write_sequential_huffman(
            jw.Frame(grey[:16, :24], "L", 75, precision=12)),
            "12-bit samples \\(SOF1"),
        "hierarchical_file": (jw.write_hierarchical(grey[:16, :24]),
                              "hierarchical file \\(DHP"),
        "lossless_arithmetic": (lossless.replace(b"\xff\xc3", b"\xff\xcb"),
                                "lossless arithmetic coding \\(SOF11"),
        "lossless_ycbcr": (jw.write_lossless(img[:20, :24], 1, 0, "YCbCr"),
                           "lossless file whose colour needs converting"),
        "arithmetic_past_64k": (small[:at] + b"\xff\xfe" + (pad + 2).to_bytes(
            2, "big") + bytes(pad) + small[at:], "pass byte 65536"),
        "two_components": (bytes(two), "2 components"),
        "jpg_marker": (base[:sof] + b"\xff\xc8\x00\x04\x00\x00" + base[sof:],
                       "unexpected marker 0xC8"),
        # 20000 x 20000: past twice Image.MAX_IMAGE_PIXELS
        "decompression_bomb": (base[:sof + 5] + bytes.fromhex("4e204e20")
                               + base[sof + 9:], "decompression-bomb"),
    }


BAD = _bad_files()
REFUSED = sorted(k for k, (_, why) in BAD.items() if why)


@pytest.mark.parametrize("kind", REFUSED)
def test_read_jpeg_refuses_what_it_does_not_read(tmp_path, kind):
    """What PIL refuses, the port refuses, naming the cause."""
    data, why = BAD[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises((OSError, SyntaxError, Image.DecompressionBombError)):
        np.asarray(Image.open(path))
    with pytest.raises(ValueError, match=f"{kind}.jpg: .*{why}"):
        read_jpeg(path)


@pytest.mark.parametrize("kind", sorted(set(BAD) - set(REFUSED)))
def test_read_jpeg_reads_what_it_once_refused(tmp_path, kind):
    """Files the port refused before and PIL decodes: the same array."""
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(BAD[kind][0])
    assert _same(read_jpeg(path)[0], np.asarray(Image.open(path)))


def _pil_same(path, data):
    path.write_bytes(data)
    ref = np.asarray(Image.open(path))
    got = read_jpeg(path)[0]
    return _same(got, ref)


# kind: (Frame colour kind, luma sampling factors)
KINDS = {"420": ("YCbCr", (2, 2)), "422": ("YCbCr", (2, 1)),
         "440": ("YCbCr", (1, 2)), "444": ("YCbCr", (1, 1)),
         "grey": ("L", (1, 1)), "rgb": ("RGB", (1, 1)),
         "cmyk": ("CMYK", (1, 1)), "ycck": ("YCCK", (2, 2))}
SHAPES = ((1, 1), (9, 17), (33, 45))


def _kind_image(rng, H, W, kind, content):
    img = _content(rng, H, W, content)
    if kind == "grey":
        return img[..., 0]
    if kind in ("cmyk", "ycck"):
        return np.concatenate([img, 255 - img[..., 1:2]], -1)
    return img


@pytest.mark.parametrize("coding", ["sequential", "restart", "dac"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_arithmetic_jpeg_matches_pil(tmp_path, kind, coding):
    """Arithmetic-coded sequential files (SOF9): every colour kind and
    sampling, restart markers every 2 MCUs, DAC conditioning (L, U and K
    other than the defaults)."""
    rng = np.random.default_rng(len(kind) + 7 * len(coding))
    opts = {"sequential": {}, "restart": dict(restart=2),
            "dac": dict(dac={0: (2, 5), 1: (1, 1), 16: 2, 17: 40})}[coding]
    for H, W in SHAPES:
        for content in ("noise", "smooth"):
            img = _kind_image(rng, H, W, kind, content)
            for q in (30, 95):
                f = jw.Frame(img, *KINDS[kind][:1], q, KINDS[kind][1])
                assert _pil_same(tmp_path / "a.jpg",
                                 jw.write_arithmetic(f, **opts)), (H, W, q)


# scan scripts of (components, Ss, Se, Ah, Al); (0, 1, 2) the components
# a file has
SCRIPTS = {
    # libjpeg's jpeg_simple_progression for YCbCr
    "simple": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
               ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)],
    # spectral selection alone, each component's DC in a scan of its own
    "spectral": [((0,), 0, 0, 0, 0), ((1,), 0, 0, 0, 0), ((2,), 0, 0, 0, 0),
                 ((0,), 1, 2, 0, 0), ((1,), 1, 9, 0, 0), ((0,), 3, 9, 0, 0),
                 ((2,), 1, 63, 0, 0), ((0,), 10, 63, 0, 0),
                 ((1,), 10, 63, 0, 0)],
    # deep successive approximation
    "approximation": [((0, 1, 2), 0, 0, 0, 3), ((0,), 1, 63, 0, 4),
                      ((0, 1, 2), 0, 0, 3, 2), ((1,), 1, 63, 0, 2),
                      ((0,), 1, 63, 4, 3), ((2,), 1, 63, 0, 1),
                      ((0,), 1, 63, 3, 2), ((0, 1, 2), 0, 0, 2, 1),
                      ((0,), 1, 63, 2, 1)],
}


def _script(name, n):
    """The script for a file of n components: the scans of components it
    lacks dropped, (0, 1, 2) cut to its components."""
    out = []
    for comps, ss, se, ah, al in SCRIPTS[name]:
        comps = tuple(c for c in comps if c < n)
        if comps:
            out.append((comps, ss, se, ah, al))
    return out


def _cuts(data):
    """The file cut before each of its scans after the first, ended by EOI:
    each leaves the later scans' bits unsent."""
    at = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return [data[:i] + b"\xff\xd9" for i in at[1:]] + [data]


@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("kind", ["420", "422", "440", "444", "grey"])
def test_read_unrefined_progressive_matches_pil(tmp_path, kind, script,
                                                coding):
    """Progressive files cut after every scan of a chosen script: the
    blocks whose coefficients 1-9 lack bits are smoothed as libjpeg
    smooths them (and their DC interpolated while no AC bit was sent)."""
    rng = np.random.default_rng(len(kind) + len(script))
    write = jw.write_progressive_huffman if coding == "huffman" else \
        jw.write_arithmetic
    for H, W in ((9, 17), (33, 45)):
        for content in ("noise", "smooth"):
            img = _kind_image(rng, H, W, kind, content)
            f = jw.Frame(img, *KINDS[kind][:1], 60, KINDS[kind][1])
            data = write(f, _script(script, len(f.ids)),
                         restart=3 if content == "smooth" else 0)
            for i, cut in enumerate(_cuts(data)):
                assert _pil_same(tmp_path / "p.jpg", cut), (H, W, content, i)


@pytest.mark.parametrize("sub", [0, 1, 2, "L"],
                         ids=["444", "422", "420", "grey"])
def test_read_pils_progressive_cut_after_each_scan_matches_pil(tmp_path,
                                                                sub):
    """PIL's own progressive files (libjpeg's simple progression), ended
    after each of their scans."""
    rng = np.random.default_rng(17)
    for H, W in ((1, 1), (15, 17), (48, 64)):
        for q in (10, 90):
            img = _content(rng, H, W, "smooth")
            opts = dict(quality=q, progressive=True)
            if sub == "L":
                img = img[..., 1]
            else:
                opts["subsampling"] = sub
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", **opts)
            for i, cut in enumerate(_cuts(buf.getvalue())):
                assert _pil_same(tmp_path / "c.jpg", cut), (H, W, q, i)


@pytest.mark.parametrize("kind", ["cmyk", "ycck"])
@pytest.mark.parametrize("factors", [(1, 1), (2, 2), (2, 1)],
                         ids=["h1v1", "h2v2", "h2v1"])
def test_read_cmyk_jpeg_matches_pil(tmp_path, kind, factors):
    """4-component files, Huffman-coded: CMYK (an Adobe segment of
    transform 0, or none) and YCCK (transform 2, or any other but 0, as
    libjpeg assumes), the first component at
    `factors`, stored inverted as PIL's `CMYK;I`; and PIL's own CMYK
    files, baseline and progressive."""
    rng = np.random.default_rng(factors[0] + 3 * factors[1])
    for H, W in SHAPES:
        img = _kind_image(rng, H, W, kind, "noise")
        f = jw.Frame(img, kind.upper(), 80, factors)
        data = jw.write_sequential_huffman(f)
        assert _pil_same(tmp_path / "k.jpg", data), (H, W)
        if kind == "ycck":            # any Adobe transform but 0 is YCCK
            at = data.index(b"Adobe") + 11
            for t in (1, 3, 255):
                assert _pil_same(tmp_path / "k.jpg",
                                 data[:at] + bytes([t]) + data[at + 1:])
        if kind == "cmyk":
            assert _pil_same(tmp_path / "k.jpg", jw.write_sequential_huffman(
                f, app=False)), (H, W)
            for opts in (dict(quality=90), dict(quality=40, progressive=True)):
                buf = io.BytesIO()
                Image.fromarray(img, "CMYK").save(buf, "JPEG", **opts)
                assert _pil_same(tmp_path / "k.jpg", buf.getvalue())


@pytest.mark.parametrize("psv", range(1, 8))
def test_read_lossless_jpeg_matches_pil(tmp_path, psv):
    """Lossless files (SOF3) of predictor `psv`: grey at point transforms
    0 and 3, RGB (an Adobe segment of transform 0) interleaved or in a
    scan per component, with restart intervals, and with the first
    component sampled 2x1 (upsampled plainly, not fancily)."""
    rng = np.random.default_rng(psv)
    img = _content(rng, 13, 22, "noise" if psv % 2 else "smooth")
    for data in (jw.write_lossless(img[..., 0], psv, 0),
                 jw.write_lossless(img[..., 1], psv, 3, restart_rows=2),
                 jw.write_lossless(img, psv, 0, "RGB"),
                 jw.write_lossless(img, psv, 1, "RGB", interleave=False,
                                   restart_rows=3),
                 jw.write_lossless(img, psv, 0, "RGB", factors=(2, 1))):
        assert _pil_same(tmp_path / "l.jpg", data)


def _corrupt_sources():
    """{coding: a valid file}: PIL's baseline, restart and progressive
    files, and the writers' arithmetic, unrefined, lossless and YCCK
    ones."""
    rng = np.random.default_rng(99)
    img = _content(rng, 37, 61, "noise")
    out = {}
    for name, opts in (("b420", dict(quality=80, subsampling=2)),
                       ("b422rst", dict(quality=60, subsampling=1,
                                        restart_marker_rows=1)),
                       ("grey", dict(quality=90)),
                       ("p420rst", dict(quality=70, progressive=True,
                                        subsampling=2,
                                        restart_marker_blocks=2))):
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if name == "grey" else img).save(
            buf, "JPEG", **opts)
        out[name] = buf.getvalue()
    f = jw.Frame(img, "YCbCr", 80)
    out["arith420rst"] = jw.write_arithmetic(f, restart=2)
    out["arithprog"] = jw.write_arithmetic(f, SCRIPTS["simple"][:7],
                                           restart=3)
    out["unrefined"] = jw.write_progressive_huffman(
        f, SCRIPTS["simple"][:3], restart=2)
    out["lossless"] = jw.write_lossless(img, 5, 0, "RGB", restart_rows=4)
    out["ycck"] = jw.write_sequential_huffman(jw.Frame(
        np.concatenate([img, img[..., :1]], -1), "YCCK", 80), restart=3)
    return out


CORRUPT = _corrupt_sources()


@pytest.mark.parametrize("coding", sorted(CORRUPT))
def test_read_corrupt_jpeg_matches_pil(tmp_path, coding):
    """Files whose scans and segments were damaged at random (bytes
    changed, deleted or made a marker, bits flipped): where PIL decodes
    one the port gives its array, where PIL refuses it the port raises.
    libjpeg's recovery decides: zeros past a marker and the rest of the
    restart interval left blank, a lost restart marker resynchronised, a
    bad code read as 0, the SIMD inverse DCT's 16-bit saturation, the
    image kept where only what follows a single scan is cut short."""
    rng = np.random.default_rng(len(coding))
    data = CORRUPT[coding]
    sos = data.index(b"\xff\xda")
    path = tmp_path / "c.jpg"
    decoded = 0
    for trial in range(60):
        d = bytearray(data)
        for _ in range(1 + trial % 3):
            kind, i = int(rng.integers(0, 4)), int(rng.integers(sos + 10,
                                                               len(d) - 2))
            if kind == 0:
                d[i] = int(rng.integers(0, 256))
            elif kind == 1:
                d[i:i + 2] = bytes([0xFF, int(rng.integers(0xC0, 0xFF))])
            elif kind == 2:
                del d[i:i + int(rng.integers(1, 9))]
            else:
                d[i] ^= 1 << int(rng.integers(0, 8))
        path.write_bytes(bytes(d))
        try:
            ref = np.asarray(Image.open(path))
        except (OSError, SyntaxError):
            with pytest.raises(ValueError, match="c.jpg: "):
                read_jpeg(path)
            continue
        assert _same(read_jpeg(path)[0], ref), trial
        decoded += 1
    assert decoded >= 20


def test_read_sequential_jpeg_without_tables_matches_pil(tmp_path):
    """A sequential file without DHT segments decodes with the standard
    tables (libjpeg-turbo's jstdhuff.c, for Motion-JPEG frames); a
    progressive one is refused, as libjpeg refuses it."""
    rng = np.random.default_rng(23)
    for prog in (False, True):
        buf = io.BytesIO()
        Image.fromarray(_content(rng, 24, 40, "noise")).save(
            buf, "JPEG", quality=80, progressive=prog)
        data, i, out = buf.getvalue(), 2, [b"\xff\xd8"]
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], "big")
            if data[i + 1] != 0xC4:             # the tables dropped
                out.append(data[i:i + 2 + n])
            i += 2 + n
        path = tmp_path / "t.jpg"
        path.write_bytes(b"".join(out) + data[i:])
        if prog:
            with pytest.raises(OSError):
                np.asarray(Image.open(path))
            with pytest.raises(ValueError, match="undefined Huffman table"):
                read_jpeg(path)
        else:
            assert _pil_same(path, path.read_bytes())


def test_read_jpeg_after_junk_and_stray_markers_matches_pil(tmp_path):
    """Bytes between segments are skipped and a stray RSTn ignored, as
    libjpeg and PIL's header reader do."""
    rng = np.random.default_rng(21)
    buf = io.BytesIO()
    Image.fromarray(_content(rng, 24, 40, "noise")).save(buf, "JPEG",
                                                         quality=70)
    data = buf.getvalue()
    sof = data.index(b"\xff\xc0")
    for extra in (b"\x12\x34", b"\xff\xd3", b"\xff\x00\x07"):
        assert _pil_same(tmp_path / "j.jpg", data[:sof] + extra + data[sof:])
    assert _pil_same(tmp_path / "j.jpg", data[:-2] + b"\xff\xd5\x01" +
                     data[-2:])


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("quality", [10, 50, 95, 100])
def test_write_jpeg_decodes_alike_in_pil(tmp_path, quality, subsampling):
    rng = np.random.default_rng(quality)
    path = tmp_path / "w.jpg"
    for H, W in ((1, 1), (15, 17), (97, 161)):
        for kind in ("noise", "smooth"):
            img = _content(rng, H, W, kind)
            for x in (img, img[..., 2]):
                write_jpeg(path, x, quality, subsampling)
                ref = np.asarray(Image.open(path))
                assert _same(read_jpeg(path)[0], ref)
                assert Image.open(path).format == "JPEG"


def _pil_bytes(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [75, 85])
def test_encode_jpeg_writes_pils_file(quality, mode, kind):
    """PIL's defaults, 4:2:0 for RGB: the same bytes, so the same pixels,
    at the evaluation's and the viewer's qualities; sizes that leave
    partial MCUs at the right and the bottom (libjpeg's dummy blocks)."""
    rng = np.random.default_rng(quality + len(kind))
    for H, W in ((1, 1), (7, 9), (17, 31), (45, 67), (97, 161), (120, 200)):
        img = _content(rng, H, W, kind)
        if mode == "L":
            img = img[..., 0]
        got, want = encode_jpeg(img, quality), _pil_bytes(img, quality)
        assert got == want, (H, W)
        decoded = np.asarray(Image.open(io.BytesIO(got)))
        assert _same(decoded, np.asarray(Image.open(io.BytesIO(want))))


def test_encode_jpeg_every_quality_writes_pils_file():
    rng = np.random.default_rng(41)
    img = _content(rng, 37, 53, "noise")
    for q in (1, 5, 25, 50, 51, 90, 95, 100):
        for x in (img, img[..., 1]):
            assert encode_jpeg(x, q) == _pil_bytes(x, q), q


def test_write_jpeg_quality_95_on_a_synthetic_frame(tmp_path):
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    # office0's size, as `chip_smoke.py` writes the room
    _, cams = synthetic_sequence(1, width=1200, height=680)
    src = cams[0].image
    path = tmp_path / "frame000000.jpg"
    write_jpeg(path, np.clip(np.rint(src * 255), 0, 255).astype(np.uint8),
               95, "4:2:0")
    got = read_jpeg(path)[0]
    assert _same(got, np.asarray(Image.open(path)))
    mse = float(np.mean((got.astype(np.float32) / 255.0 - src) ** 2))
    assert 10 * np.log10(1.0 / mse) >= 40.0
    with pytest.raises(ValueError, match="subsampling"):
        write_jpeg(path, got, 95, "4:2:2")


RESIZES = {
    "shrink": lambda W, H: (W // 3, H // 2),
    "shrink_scannetpp": lambda W, H: (256, 192),
    "grow": lambda W, H: (2 * W + 1, 3 * H),
    "width_only": lambda W, H: (W // 2 + 3, H),
    "height_only": lambda W, H: (W, H + 5),
    "same": lambda W, H: (W, H),
    "to_one": lambda W, H: (1, 1),
}


# PIL mode: (channels, dtype); LA and RGBA resample premultiplied
MODES = {"L": (0, np.uint8), "RGB": (3, np.uint8), "LA": (2, np.uint8),
         "RGBA": (4, np.uint8), "I;16": (0, np.uint16)}


def _mode_image(rng, H, W, mode):
    ch, dt = MODES[mode]
    img = rng.integers(0, np.iinfo(dt).max + 1, (H, W, ch) if ch else (H, W))
    img = img.astype(dt)
    if mode in ("LA", "RGBA"):
        # alpha 0 and 255 (taken as they are) and partial
        img[..., -1] = rng.choice([0, 255, 1, 128, 254], (H, W))
    return img


@pytest.mark.parametrize("case", sorted(RESIZES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resize_like_pil_matches_pil(mode, case):
    rng = np.random.default_rng(len(case))
    shapes = ((1440, 1920),) if case == "shrink_scannetpp" else \
        ((1, 1), (7, 5), (48, 64), (97, 161))
    if case == "shrink_scannetpp" and mode not in ("L", "RGB"):
        shapes = ((480, 640),)
    for H, W in shapes:
        img = _mode_image(rng, H, W, mode)
        size = tuple(max(1, s) for s in RESIZES[case](W, H))
        pil = Image.fromarray(img, mode if mode == "LA" else None)
        assert pil.mode == mode
        ref = np.asarray(pil.resize(size))
        got = resize_like_pil(img, size)
        assert _same(got, ref), (H, W, size)
        assert not np.shares_memory(got, img)


@pytest.mark.parametrize("case", sorted(RESIZES))
@pytest.mark.parametrize("mode", ["P", "1", "CMYK"])
def test_resize_like_pil_with_a_mode_matches_pil(mode, case):
    """The modes an array does not tell: `P` and `1`, which Pillow resizes
    NEAREST whatever the resample, and `CMYK`, resized BICUBIC band by
    band, unpremultiplied."""
    rng = np.random.default_rng(len(case) + len(mode))
    for H, W in ((1, 1), (7, 5), (48, 64), (97, 161)):
        if mode == "P":
            img = rng.integers(0, 16, (H, W)).astype(np.uint8)
            pil = Image.fromarray(img, "P")
            pil.putpalette(list(range(48)))
        elif mode == "1":
            img = rng.integers(0, 2, (H, W)).astype(bool)
            pil = Image.fromarray(img)
        else:
            img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
            pil = Image.fromarray(img, "CMYK")
        assert pil.mode == mode
        size = tuple(max(1, s) for s in RESIZES[case](W, H))
        got = resize_like_pil(img, size, mode)
        assert _same(got, np.asarray(pil.resize(size))), (H, W, size)
        assert not np.shares_memory(got, img)


def test_resize_like_pil_refuses_other_images():
    """Kinds Pillow resizes otherwise or not at all, without a mode: mode
    `1` (bool) and palette images go NEAREST, float and 32-bit images
    through its 32-bit path; a mode the array is not of, or one Pillow
    does not have; at its own size any image is a copy."""
    for bad in (np.zeros((4, 4), bool), np.zeros((4, 4), np.float32),
                np.zeros((4, 4), np.int32), np.zeros((4, 4, 5), np.uint8),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError, match="uint8"):
            resize_like_pil(bad, (2, 2))
        same = resize_like_pil(bad, (4, 4))
        assert _same(same, bad) and not np.shares_memory(same, bad)
    for img, mode in ((np.zeros((4, 4), np.uint8), "1"),
                      (np.zeros((4, 4, 3), np.uint8), "CMYK"),
                      (np.zeros((4, 4), np.uint16), "P")):
        with pytest.raises(ValueError, match=f"a {mode} image is"):
            resize_like_pil(img, (2, 2), mode)
    with pytest.raises(ValueError, match="unknown mode 'YCbCr'"):
        resize_like_pil(np.zeros((4, 4, 3), np.uint8), (2, 2), "YCbCr")


HASHES = json.loads((FIXTURES / "hashes.json").read_text())


@pytest.mark.parametrize("name", sorted(HASHES))
def test_fixture_hashes_are_pils(name):
    """Each fixture's array, mode and (CMYK) resized array against PIL's,
    and the port's reading of it."""
    path = FIXTURES / name
    im = Image.open(path)
    ref = np.asarray(im)
    want = HASHES[name]
    assert list(ref.shape) == want["shape"] and im.mode == want["mode"]
    assert hashlib.sha256(ref.tobytes()).hexdigest() == want["sha256"]
    got, mode = read_jpeg(path)
    assert _same(got, ref) and mode == im.mode
    assert ("resized" in want) == (mode == "CMYK")
    if "resized" in want:
        from make_png_fixtures import resize_size
        size = resize_size(*im.size)
        small = np.asarray(im.resize(size))
        assert hashlib.sha256(small.tobytes()).hexdigest() == \
            want["resized"]["sha256"]
        assert _same(resize_like_pil(got, size, mode), small)


def test_fixtures_are_small():
    files = sorted(FIXTURES.glob("*.jpg"))
    assert len(files) <= 36 and {f.name for f in files} == set(HASHES)
    assert sum(f.stat().st_size for f in files) < 200_000


@pytest.mark.parametrize("name", sorted(n for n in HASHES
                                        if n.startswith("enc_")))
def test_encoder_fixtures_are_encode_jpegs(name):
    """The encoder's references, which `chip_smoke.py` holds `encode_jpeg`
    to on the card, are what it writes from their input."""
    sys.path.insert(0, str(FIXTURES.parent))
    from make_jpeg_fixtures import ENCODER, encoder_input
    kind, q = ENCODER[name]
    assert encode_jpeg(encoder_input(grey=kind == "grey"), q) == \
        (FIXTURES / name).read_bytes()


def test_decoder_build_is_cached_and_failures_raise(tmp_path, monkeypatch):
    path = jpeg.build_library()
    assert path.parent == jpeg.BUILD_DIR and path.exists()
    assert path.name.startswith("libjpeg_decode_")
    assert jpeg.build_library() == path                     # cached
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SOURCE", bad)
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        jpeg.build_library()
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        jpeg.build_library()
