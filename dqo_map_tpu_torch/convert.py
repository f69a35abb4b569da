"""Carry a Gaussian map across the two implementations as numpy arrays.

`map_state_from_numpy` takes the fields of the JAX package's `MapState`
read with `np.asarray` (or those `map_state_to_numpy` wrote) and builds
the port's `MapState`; `map_state_to_numpy` does the reverse. Field names,
shapes and dtypes are the same on both sides; `count` is a 0-d int32.
`map_state_from_checkpoint` reads the map of a checkpoint that either
package wrote (both store it as `map_<field>` arrays in `<path>.npz`); a
PLY either package wrote loads through `utils.ply.load_map_ply`.

`objects_from_jax` reads the JAX package's `ObjectLayer` into the numpy
form of the port's `ObjectLayer.state_dict` (ellipsoids, observations,
category, id, colour, the frame's detections and the generator state), for
`ObjectLayer.load_state_dict`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gaussian_map import FIELDS, MapState
from .models.quadrics import layer_state


def map_state_from_numpy(d: dict, device="cuda") -> MapState:
    return MapState(
        **{f: torch.as_tensor(np.array(d[f]), device=device) for f in FIELDS},
        count=int(np.asarray(d["count"])),
    )


def map_state_to_numpy(state: MapState) -> dict:
    out = {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}
    out["count"] = np.int32(state.count)
    return out


def map_state_from_checkpoint(path: str, device="cuda") -> MapState:
    """The map of the checkpoint `path` (with or without its `.npz`)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        return map_state_from_numpy(
            {f: z[f"map_{f}"] for f in FIELDS + ("count",)}, device)


def objects_from_jax(layer) -> dict:
    """The objects of a JAX `ObjectLayer` as the port's layer state. The id
    counter is the JAX objects' class counter; the capacity receipts are
    left as they are."""
    next_id = max([type(o)._next_id for o in layer.objects], default=0)
    return layer_state(layer.objects, layer.current_dets,
                       layer.rng.bit_generator.state, layer.iou_log,
                       getattr(layer, "_K", None), next_id, None)
