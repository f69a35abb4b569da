"""Carry a Gaussian map across the two implementations as numpy arrays.

`map_state_from_numpy` takes the fields of the JAX package's `MapState`
read with `np.asarray` (or those `map_state_to_numpy` wrote) and builds
the port's `MapState`; `map_state_to_numpy` does the reverse. Field names,
shapes and dtypes are the same on both sides; `count` is a 0-d int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gaussian_map import FIELDS, MapState


def map_state_from_numpy(d: dict, device="cuda") -> MapState:
    return MapState(
        **{f: torch.as_tensor(np.array(d[f]), device=device) for f in FIELDS},
        count=int(np.asarray(d["count"])),
    )


def map_state_to_numpy(state: MapState) -> dict:
    out = {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}
    out["count"] = np.int32(state.count)
    return out
