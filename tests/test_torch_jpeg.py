"""The port's JPEG decoder (`utils/jpeg.py::read_jpeg`, built from
`csrc/jpeg_decode.cc`), its small encoder (`write_jpeg`) and
`utils/resize.py::resize_like_pil`, against PIL, exactly, on the CPU.

- `read_jpeg` gives `np.asarray(Image.open(path))` bit for bit: sizes
  1x1 to 1200x680, PIL's subsampling 0 (4:4:4), 1 (4:2:2), 2 (4:2:0) and
  mode `L`, qualities 5 to 100, noise and smooth content; optimised
  Huffman tables and restart markers (by blocks and by rows); luma
  sampling factors PIL does not write (4:4:0, 4:1:1 and others, through
  the encoder's `factors`); an Adobe file of colour transform 1.
- Progressive, arithmetic-coded, lossless, 12-bit, CMYK, RGB, truncated
  and corrupt files raise `ValueError` naming the file and the cause.
- PIL decodes `write_jpeg`'s files to the arrays `read_jpeg` gives, and a
  synthetic room frame at 1200x680, quality 95, 4:2:0, is above 40 dB.
- `resize_like_pil` gives `Image.resize(size)` (BICUBIC) bit for bit for
  `L` and `RGB`: shrink, grow, one axis, the same size.
- The committed fixtures' hashes (`tests/torch_fixtures/jpeg/`, which
  `chip_smoke.py` holds the decoder to) are PIL's.
- The decoder's g++ build is cached in `_build/`, and a failed build
  raises.
"""

import hashlib
import io
import json
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
    # the component ids 1, 2, 3 renamed 'R', 'G', 'B' in the frame and
    # the scan header
    ids_rgb = bytearray(base)
    for at, stride in ((sof + 10, 3), (sos + 5, 2)):
        ids_rgb[at:at + 3 * stride:stride] = b"RGB"
    return {
        "progressive": (save(quality=80, progressive=True),
                        "progressive \\(SOF2"),
        "arithmetic": (base[:sof] + b"\xff\xc9" + base[sof + 2:],
                       "arithmetic coding \\(SOF9"),
        "lossless": (base[:sof] + b"\xff\xc3" + base[sof + 2:],
                     "lossless \\(SOF3"),
        "12bit": (base[:sof + 4] + bytes([12]) + base[sof + 5:],
                  "12-bit samples"),
        "cmyk": (save(quality=80, mode="CMYK"), "4 components"),
        "adobe_rgb": (_replace_app0(base, _adobe(0)),
                      "Adobe colour transform 0"),
        "ids_rgb": (_replace_app0(bytes(ids_rgb), b""),
                    "component ids R, G, B"),
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


@pytest.mark.parametrize("case", sorted(RESIZES))
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_resize_like_pil_matches_pil(mode, case):
    rng = np.random.default_rng(len(case))
    shapes = ((1440, 1920),) if case == "shrink_scannetpp" else \
        ((1, 1), (7, 5), (48, 64), (97, 161))
    for H, W in shapes:
        img = rng.integers(0, 256, (H, W) if mode == "L" else (H, W, 3))
        img = img.astype(np.uint8)
        size = tuple(max(1, s) for s in RESIZES[case](W, H))
        ref = np.asarray(Image.fromarray(img, mode).resize(size))
        got = resize_like_pil(img, size)
        assert _same(got, ref), (H, W, size)
        assert not np.shares_memory(got, img)


def test_resize_like_pil_refuses_other_images():
    with pytest.raises(ValueError, match="uint8"):
        resize_like_pil(np.zeros((4, 4), np.uint16), (2, 2))
    with pytest.raises(ValueError, match="uint8"):
        resize_like_pil(np.zeros((4, 4, 4), np.uint8), (2, 2))


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
    assert len(files) <= 12 and {f.name for f in files} == set(HASHES)
    assert sum(f.stat().st_size for f in files) < 200_000


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
