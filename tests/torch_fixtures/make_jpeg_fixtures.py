"""Write the JPEG fixtures of `tests/torch_fixtures/jpeg/` with PIL, and
beside them `hashes.json`: each file's decoded shape and the SHA-256 of
the array PIL decodes it to. They hold the port's decoder to PIL on a
machine without PIL (`chip_smoke.py`); `tests/test_torch_jpeg.py`
re-derives the hashes with PIL.

    python tests/torch_fixtures/make_jpeg_fixtures.py
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

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


def adobe_transform_1(data: bytes) -> bytes:
    """The file with its JFIF APP0 segment replaced by an Adobe APP14 one of
    colour transform 1 (YCbCr)."""
    assert data[2:4] == b"\xff\xe0"
    app0_end = 4 + int.from_bytes(data[4:6], "big")
    app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 1])
    seg = b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big") + app14
    return data[:2] + seg + data[app0_end:]


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


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(2024)
    hashes = {}
    for name, (H, W, kind, mode, opts) in FIXTURES.items():
        img = content(rng, H, W, kind)
        pil = Image.fromarray(img if mode == "RGB" else img[..., 1], mode)
        buf = io.BytesIO()
        pil.save(buf, "JPEG", **opts)
        data = buf.getvalue()
        if "adobe1" in name:
            data = adobe_transform_1(data)
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        arr = np.asarray(Image.open(path))
        hashes[name] = {"shape": list(arr.shape),
                        "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
