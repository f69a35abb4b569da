"""The port's synthetic orbit (`data/synthetic.py::synthetic_sequence`):
the eye on an ellipse of radius `radius` (x) and 0.3 x `radius` (z) with a
vertical bob, looking 0.5 rad ahead along a circle of radius 1.8 m, the
angle advancing `step_rad` a frame."""

import numpy as np


def eye_target(i: int, p: dict):
    ang = i * float(p["step_rad"])
    r = float(p.get("radius", 0.9))
    eye = np.array([r * np.sin(ang), 0.15 * np.sin(2 * ang),
                    0.3 * r * np.cos(ang)])
    target = np.array([1.8 * np.sin(ang + 0.5), 0.3, 1.8 * np.cos(ang + 0.5)])
    return eye, target
