"""Per-frame object detection IO (bbox + ellipse JSON).

Equivalent of `read_from_json` + `get_2dim_quarics`
(`SLAM/multiprocess/quadrics.py:72-127,249-282`). The JSON holds one entry
per frame: {file_name, detections: [{category_id, detection_score, bbox,
ellipse?, color?}]}. Output is the flat per-detection dict list the object
layer consumes. A copy of `dqo_map_tpu/data/detections.py`.
"""

from __future__ import annotations

import json
import os

import numpy as np


def check_bbox(bbox, H, W, bounding=5):
    return not (bbox[0] < bounding or bbox[1] < bounding
                or bbox[2] > W - bounding or bbox[3] > H - bounding)


def load_detection_json(path: str, img_width: int, img_height: int):
    """Returns (timestamps, per-frame detection lists)."""
    with open(path, "r") as f:
        data = json.load(f)
    timestamps = []
    frames = []
    for entry in data:
        fname = entry.get("file_name", "0")
        try:
            timestamps.append(float(os.path.splitext(fname)[0]))
        except ValueError:
            timestamps.append(float(len(timestamps)))
        dets = []
        for d in entry.get("detections", []):
            if not check_bbox(d["bbox"], img_height, img_width):
                continue
            det = {
                "cat": d["category_id"],
                "score": d.get("detection_score", 1.0),
                "bbox": list(d["bbox"]),
                "ellipse": list(d["ellipse"]) if "ellipse" in d else None,
                "color": d.get("color", [128, 128, 128]),
            }
            dets.append(det)
        frames.append(dets)
    return np.asarray(timestamps), frames
