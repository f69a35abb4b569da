"""Write the JPEG fixtures of `tests/torch_fixtures/jpeg/` with PIL and
`jpeg_writers.py`, and beside them `hashes.json`: each file's decoded
shape, PIL's mode and the SHA-256 of the array PIL decodes it to (for a
CMYK file also of the array `Image.resize` gives at
`make_png_fixtures.py::resize_size`). They hold the port's decoder to PIL on a
machine without PIL (`chip_smoke.py`, which imports `encoder_input` and
`ENCODER` from here: PIL is imported only to write the files);
`tests/test_torch_jpeg.py` re-derives the hashes with PIL. Besides baseline files: progressive ones
(grey, 4:2:0, 4:2:2, 4:4:4, with restart intervals, optimised tables and
odd sizes, and the synthetic room's first frame at 1200x680), an Adobe
RGB one (colour transform 0), and the encoder's references: PIL's files
of `encoder_input` at quality 75 and 85 (4:2:0 and grey), which the
port's `encode_jpeg` writes byte for byte; and the kinds PIL cannot write
(`written`): arithmetic-coded (sequential with restarts and DAC
conditioning, progressive, one ended early), progressive files whose
scans leave bits unsent, YCCK, lossless, PIL's CMYK, and the room frame
arithmetic-coded and progressive ended after its fourth scan.

    python tests/torch_fixtures/make_jpeg_fixtures.py
"""

import hashlib
import io
import json
import os

import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg")


def content(rng, H, W, kind):
    if kind == "noise":
        return rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 9.0 + y / 23.0),
                    128 + 90 * np.cos(y / 7.0),
                    (3 * x + 2 * y) % 256], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def adobe_transform(data: bytes, transform: int = 1) -> bytes:
    """The file with its JFIF APP0 segment replaced by an Adobe APP14 one of
    colour `transform` (1 YCbCr, 0 RGB)."""
    assert data[2:4] == b"\xff\xe0"
    app0_end = 4 + int.from_bytes(data[4:6], "big")
    app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    seg = b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big") + app14
    return data[:2] + seg + data[app0_end:]


def encoder_input(H: int = 45, W: int = 67, grey: bool = False):
    """The encoder fixtures' image, from integer arithmetic alone so that
    any machine makes the same one: a gradient with a pseudo-random
    texture, (H, W, 3) uint8 or its (H, W) green plane."""
    y, x = np.mgrid[0:H, 0:W].astype(np.int64)
    tex = ((x * 7919 + y * 104729) ^ (x * y * 31)) % 97
    img = np.stack([(3 * x + tex) % 256, (5 * y + 2 * tex) % 256,
                    (x * y + 3 * tex) % 256], -1).astype(np.uint8)
    return img[..., 1] if grey else img


# name: (height, width, content, PIL mode, save options)
FIXTURES = {
    "rgb444_q90_29x37.jpg": (29, 37, "noise", "RGB",
                             dict(quality=90, subsampling=0)),
    "rgb422_q75_33x65.jpg": (33, 65, "smooth", "RGB",
                             dict(quality=75, subsampling=1)),
    "rgb420_q95_97x161.jpg": (97, 161, "smooth", "RGB",
                              dict(quality=95, subsampling=2)),
    "rgb420_q50_1x1.jpg": (1, 1, "noise", "RGB",
                           dict(quality=50, subsampling=2)),
    "rgb420_q80_3x5.jpg": (3, 5, "noise", "RGB",
                           dict(quality=80, subsampling=2)),
    "grey_q85_17x15.jpg": (17, 15, "noise", "L", dict(quality=85)),
    "rgb420_rst3_61x97.jpg": (61, 97, "smooth", "RGB",
                              dict(quality=90, subsampling=2,
                                   restart_marker_blocks=3)),
    "rgb422_rstrow_48x64.jpg": (48, 64, "noise", "RGB",
                                dict(quality=70, subsampling=1,
                                     restart_marker_rows=1)),
    "rgb444_opt_q100_24x40.jpg": (24, 40, "noise", "RGB",
                                  dict(quality=100, subsampling=0,
                                       optimize=True)),
    "grey_opt_rst_q60_43x81.jpg": (43, 81, "smooth", "L",
                                   dict(quality=60, optimize=True,
                                        restart_marker_blocks=2)),
    "rgb420_q5_opt_180x320.jpg": (180, 320, "smooth", "RGB",
                                  dict(quality=5, subsampling=2,
                                       optimize=True)),
    "rgb420_adobe1_45x71.jpg": (45, 71, "smooth", "RGB",
                                dict(quality=88, subsampling=2)),
}


# written after FIXTURES, from a generator of their own
PROGRESSIVE = {
    "prog_grey_q80_23x41.jpg": (23, 41, "smooth", "L", dict(quality=80)),
    "prog420_rst2_opt_37x59.jpg": (37, 59, "noise", "RGB",
                                   dict(quality=70, subsampling=2,
                                        restart_marker_blocks=2,
                                        optimize=True)),
    "prog422_q90_31x47.jpg": (31, 47, "smooth", "RGB",
                              dict(quality=90, subsampling=1)),
    "prog444_rstrow_q60_19x29.jpg": (19, 29, "noise", "RGB",
                                     dict(quality=60, subsampling=0,
                                          restart_marker_rows=1)),
    "rgb420_adobe0_33x45.jpg": (33, 45, "smooth", "RGB",
                                dict(quality=85, subsampling=2)),
}
ENCODER = {f"enc_{kind}_q{q}_45x67.jpg": (kind, q) for kind in ("rgb", "grey")
           for q in (75, 85)}
ROOM = "room_prog_q75_1200x680.jpg"
ROOM_ARITH = "room_arith_q75_1200x680.jpg"
ROOM_SMOOTH = "room_prog_cut4_q75_1200x680.jpg"


def _write(path, data):
    from PIL import Image
    with open(path, "wb") as f:
        f.write(data)
    im = Image.open(path)
    out = {**_entry(im), "mode": im.mode}
    if im.mode == "CMYK":               # resized band by band by Pillow
        from make_png_fixtures import resize_size
        out["resized"] = _entry(im.resize(resize_size(*im.size)))
    return out


def _entry(im) -> dict:
    arr = np.asarray(im)
    return {"shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def written(room: np.ndarray) -> dict:
    """The fixtures of the kinds PIL cannot write (`jpeg_writers.py`), and
    PIL's CMYK one: {name: file bytes}. Among them the room frame
    arithmetic-coded, and PIL's progressive room file ended after its
    fourth scan (bits of coefficients 1-9 unsent: smoothed)."""
    import jpeg_writers as jw
    from PIL import Image
    rng = np.random.default_rng(12)
    rgb = content(rng, 33, 45, "smooth")
    noise = content(rng, 29, 37, "noise")
    cmyk = np.concatenate([noise, 255 - noise[..., :1]], -1)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=85)
    prog = _pil_bytes(room, "RGB", quality=75, progressive=True,
                      optimize=True)
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    simple = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
              ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
              ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
              ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
              ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    return {
        "arith420_rst_dac_33x45.jpg": jw.write_arithmetic(
            jw.Frame(rgb, "YCbCr", 80), restart=3,
            dac={0: (1, 4), 1: (0, 2), 16: 10, 17: 3}),
        "arith_prog444_29x37.jpg": jw.write_arithmetic(
            jw.Frame(noise, "YCbCr", 70, (1, 1)), simple),
        "arith_prog_cut_grey_33x45.jpg": jw.write_arithmetic(
            jw.Frame(rgb[..., 1], "L", 60), [((0,), 0, 0, 0, 2),
                                             ((0,), 1, 2, 0, 1)]),
        "unrefined420_33x45.jpg": jw.write_progressive_huffman(
            jw.Frame(rgb, "YCbCr", 75), simple[:6], restart=4),
        "unrefined_dc_only_29x37.jpg": jw.write_progressive_huffman(
            jw.Frame(noise, "YCbCr", 50, (2, 1)), simple[:1]),
        "cmyk_q85_29x37.jpg": buf.getvalue(),
        "ycck_arith_29x37.jpg": jw.write_arithmetic(
            jw.Frame(cmyk, "YCCK", 75)),
        "lossless_rgb_psv4_33x45.jpg": jw.write_lossless(rgb, 4, 0, "RGB",
                                                         restart_rows=5),
        "lossless_grey_psv7_pt2_29x37.jpg": jw.write_lossless(
            noise[..., 2], 7, 2),
        ROOM_ARITH: jw.write_arithmetic(jw.Frame(room, "YCbCr", 75)),
        ROOM_SMOOTH: prog[:scans[4]] + b"\xff\xd9",
    }


def _pil_bytes(img, mode, **opts):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(2024)
    hashes = {}
    for name, (H, W, kind, mode, opts) in FIXTURES.items():
        img = content(rng, H, W, kind)
        data = _pil_bytes(img if mode == "RGB" else img[..., 1], mode, **opts)
        if "adobe1" in name:
            data = adobe_transform(data, 1)
        hashes[name] = _write(os.path.join(OUT, name), data)
    rng = np.random.default_rng(2026)
    for name, (H, W, kind, mode, opts) in PROGRESSIVE.items():
        img = content(rng, H, W, kind)
        img = img if mode == "RGB" else img[..., 1]
        if "adobe0" in name:
            data = adobe_transform(_pil_bytes(img, mode, **opts), 0)
        else:
            data = _pil_bytes(img, mode, progressive=True, **opts)
        hashes[name] = _write(os.path.join(OUT, name), data)
    for name, (kind, q) in ENCODER.items():
        img = encoder_input(grey=kind == "grey")
        hashes[name] = _write(os.path.join(OUT, name), _pil_bytes(
            img, "L" if kind == "grey" else "RGB", quality=q))
    # the synthetic room's first frame, as the readers would meet it
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    _, cams = synthetic_sequence(1, width=1200, height=680)
    room = np.clip(np.rint(cams[0].image * 255), 0, 255).astype(np.uint8)
    hashes[ROOM] = _write(os.path.join(OUT, ROOM), _pil_bytes(
        room, "RGB", quality=75, progressive=True, optimize=True))
    for name, data in written(room).items():
        hashes[name] = _write(os.path.join(OUT, name), data)
    with open(os.path.join(OUT, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
