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
- Arithmetic-coded, lossless, hierarchical, 12-bit, CMYK, progressive
  files with unrefined coefficients or bad scan parameters, truncated and
  corrupt files raise `ValueError` naming the file and the cause.
- `encode_jpeg` writes PIL's file byte for byte (`Image.save(f, "JPEG",
  quality=q)`, 4:2:0 and grey) on noise and gradients, at sizes that are
  not multiples of 16 and at qualities 5 to 100; PIL decodes
  `write_jpeg`'s files to the arrays `read_jpeg` gives, and a synthetic
  room frame at 1200x680, quality 95, 4:2:0, is above 40 dB.
- `resize_like_pil` gives `Image.resize(size)` (BICUBIC) bit for bit for
  `L`, `RGB`, `RGBA`, `LA` and `I;16`: shrink, grow, one axis, the same
  size (a copy, whatever the image).
- The committed fixtures' hashes (`tests/torch_fixtures/jpeg/`, which
  `chip_smoke.py` holds the decoder to) are PIL's.
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
            assert _same(read_jpeg(path), ref), (kind, q)


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
                assert _same(read_jpeg(path), ref), (H, W, kind, q)


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
            assert _same(read_jpeg(path), np.asarray(Image.open(path))), \
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
    assert _same(read_jpeg(path), np.asarray(Image.open(path)))
    # no JFIF and no Adobe segment: YCbCr by the component ids 1, 2, 3
    path.write_bytes(_replace_app0(buf.getvalue(), b""))
    assert _same(read_jpeg(path), np.asarray(Image.open(path)))


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
                assert _same(read_jpeg(path), ref), (H, W, kind, q)


def test_read_progressive_jpeg_at_office0_scale(tmp_path):
    rng = np.random.default_rng(32)
    path = tmp_path / "p.jpg"
    img = _content(rng, 680, 1200, "smooth")
    for sub in (0, 2):
        ref = _pil_jpeg(path, img, quality=90, subsampling=sub,
                        progressive=True)
        assert _same(read_jpeg(path), ref)


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
            assert _same(read_jpeg(path), np.asarray(Image.open(path)))


def _bad_files():
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
    return {
        # the file cut after its first two scans: bits left unrefined
        "progressive_unrefined": (prog[:scans[2]] + b"\xff\xd9",
                                  "coefficient 1 unrefined"),
        "progressive_bad_scan": (bytes(bad_scan),
                                 "bad progressive scan parameters"),
        "hierarchical": (base[:sof] + b"\xff\xc5" + base[sof + 2:],
                         "hierarchical \\(SOF5"),
        "arithmetic": (base[:sof] + b"\xff\xc9" + base[sof + 2:],
                       "arithmetic coding \\(SOF9"),
        "lossless": (base[:sof] + b"\xff\xc3" + base[sof + 2:],
                     "lossless \\(SOF3"),
        "12bit": (base[:sof + 4] + bytes([12]) + base[sof + 5:],
                  "12-bit samples"),
        "cmyk": (save(quality=80, mode="CMYK"), "4 components"),
        "truncated": (base[:len(base) // 2], "truncated"),
        "no_eoi": (base[:-2], "truncated"),
        "marker_in_scan": (base[:sos + 40] + b"\xff\xd9", "truncated or "
                           "corrupt"),
        "not_jpeg": (b"GIF89a" + bytes(20), "not a JPEG"),
    }


BAD = _bad_files()


@pytest.mark.parametrize("kind", sorted(BAD))
def test_read_jpeg_refuses_what_it_does_not_read(tmp_path, kind):
    data, why = BAD[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{kind}.jpg: .*{why}"):
        read_jpeg(path)


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
                assert _same(read_jpeg(path), ref)
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
    got = read_jpeg(path)
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


def test_resize_like_pil_refuses_other_images():
    """Kinds Pillow resizes otherwise or not at all: mode `1` (bool) and
    palette images go NEAREST, float and 32-bit images through its 32-bit
    path; at its own size any image is a copy."""
    for bad in (np.zeros((4, 4), bool), np.zeros((4, 4), np.float32),
                np.zeros((4, 4), np.int32), np.zeros((4, 4, 5), np.uint8),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError, match="uint8"):
            resize_like_pil(bad, (2, 2))
        same = resize_like_pil(bad, (4, 4))
        assert _same(same, bad) and not np.shares_memory(same, bad)


HASHES = json.loads((FIXTURES / "hashes.json").read_text())


@pytest.mark.parametrize("name", sorted(HASHES))
def test_fixture_hashes_are_pils(name):
    path = FIXTURES / name
    ref = np.asarray(Image.open(path))
    want = HASHES[name]
    assert list(ref.shape) == want["shape"]
    assert hashlib.sha256(ref.tobytes()).hexdigest() == want["sha256"]
    assert _same(read_jpeg(path), ref)


def test_fixtures_are_small():
    files = sorted(FIXTURES.glob("*.jpg"))
    assert len(files) <= 22 and {f.name for f in files} == set(HASHES)
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
