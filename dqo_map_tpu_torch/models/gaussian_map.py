"""Fixed-capacity Gaussian map state (counterpart of
`dqo_map_tpu/models/gaussian_map.py`).

All Gaussians live in one preallocated structure of tensors with a per-slot
`status` (dead / unstable / stable):

- add      = write into the free slots [count, count + n), so alive slots
             stay packed below the `count` watermark;
- delete   = status := DEAD (slots come back at the next `compact`);
- promote  = status := STABLE, with the confidence clipped;
- renders over subsets are status filters.

Parameters are the reference's: log-space scaling, pre-sigmoid opacity, an
unnormalized wxyz rotation, SH features (16, 3) with DC first.

The functions return a new `MapState`; those that only change a few fields
share the other tensors with the state they were given.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils import trace
from ..utils.math3d import quaternion_from_two_vectors
from ..utils.sh import rgb_to_sh

DEAD = 0
UNSTABLE = 1
STABLE = 2

SH_K = 16  # (max_sh_degree+1)^2 with degree 3

FIELDS = ("xyz", "sh", "scaling", "rotation", "opacity", "confidence",
          "add_tick", "depth_err_cnt", "color_err_cnt", "frame_id", "obj_id",
          "sem_rgb", "status")


@dataclass
class MapState:
    xyz: torch.Tensor            # (N,3)
    sh: torch.Tensor             # (N,16,3)
    scaling: torch.Tensor        # (N,3) log-space
    rotation: torch.Tensor       # (N,4) raw wxyz
    opacity: torch.Tensor        # (N,) pre-sigmoid
    confidence: torch.Tensor     # (N,)
    add_tick: torch.Tensor       # (N,) int32, frame the gaussian was added
    depth_err_cnt: torch.Tensor  # (N,) int32
    color_err_cnt: torch.Tensor  # (N,) int32
    frame_id: torch.Tensor       # (N,) int32, source frame
    obj_id: torch.Tensor         # (N,) int32, object instance id (-1 = none)
    sem_rgb: torch.Tensor        # (N,3) semantic color
    status: torch.Tensor         # (N,) int32, DEAD/UNSTABLE/STABLE
    count: int                   # high-water slot mark

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)

    # --- derived quantities (activations) -----------------------------------
    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_radius(self) -> torch.Tensor:
        """(sum - min)/2 of the activated scales."""
        s = self.get_scaling()
        return (torch.sum(s, dim=1) - torch.amin(s, dim=1)) / 2

    def unstable_mask(self) -> torch.Tensor:
        return self.status == UNSTABLE

    def stable_mask(self) -> torch.Tensor:
        return self.status == STABLE

    def num_unstable(self) -> torch.Tensor:
        return torch.sum(self.status == UNSTABLE)

    def num_stable(self) -> torch.Tensor:
        return torch.sum(self.status == STABLE)


def empty_map(capacity: int, device="cuda") -> MapState:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    rotation = z(capacity, 4)
    rotation[:, 0] = 1.0
    return MapState(
        xyz=z(capacity, 3), sh=z(capacity, SH_K, 3), scaling=z(capacity, 3),
        rotation=rotation, opacity=z(capacity), confidence=z(capacity),
        add_tick=zi(capacity), depth_err_cnt=zi(capacity),
        color_err_cnt=zi(capacity), frame_id=zi(capacity),
        obj_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        sem_rgb=z(capacity, 3), status=zi(capacity), count=0,
    )


def make_new_points(xyz: torch.Tensor, normal: torch.Tensor, color: torch.Tensor,
                    valid: torch.Tensor, time: int, frame_id: int,
                    init_opacity: float, xyz_factor: tuple,
                    obj_id: Optional[torch.Tensor] = None,
                    sem_rgb: Optional[torch.Tensor] = None) -> dict:
    """Raw parameter rows for freshly sampled pixels: SH DC from the color,
    a tiny log-scale placeholder (set later by the KNN scale init), a
    rotation taking +z to the surface normal when the z factor differs,
    opacity `init_opacity`."""
    M = xyz.shape[0]
    dev = xyz.device
    mag = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / (mag + 1e-8)
    valid = valid & (torch.sum(normal, dim=-1) != 0)

    sh = torch.zeros((M, SH_K, 3), dtype=torch.float32, device=dev)
    sh[:, 0, :] = rgb_to_sh(color)
    scaling = torch.full((M, 3), math.log(1e-6), dtype=torch.float32, device=dev)
    if tuple(float(f) for f in xyz_factor) == (1.0, 1.0, 1.0):
        rots = torch.zeros((M, 4), dtype=torch.float32, device=dev)
        rots[:, 0] = 1.0
    else:
        with trace.span("make_new_points/wait"):
            z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(M, 3)
        rots = quaternion_from_two_vectors(z_axis, normal)
    opacity = torch.full((M,), math.log(init_opacity / (1 - init_opacity)),
                         dtype=torch.float32, device=dev)
    full_i = lambda v: torch.full((M,), v, dtype=torch.int32, device=dev)  # noqa: E731
    return {
        "xyz": xyz, "sh": sh, "scaling": scaling, "rotation": rots,
        "opacity": opacity, "normal": normal, "valid": valid,
        "add_tick": full_i(int(time)), "frame_id": full_i(int(frame_id)),
        "obj_id": obj_id if obj_id is not None else full_i(-1),
        "sem_rgb": sem_rgb if sem_rgb is not None
        else torch.zeros((M, 3), dtype=torch.float32, device=dev),
    }


def add_points(state: MapState, new: dict, status_value: int = UNSTABLE) -> MapState:
    """Write the valid rows of `new` into the free slots [count, count+n);
    rows past the capacity are dropped."""
    valid = new["valid"]
    pos = state.count + torch.cumsum(valid.to(torch.int64), 0) - 1
    keep = valid & (pos < state.capacity)
    M = valid.shape[0]
    dev = state.device

    # each masked gather and the count wait for the card: one span a read
    with trace.span("add_points/wait"):
        idx = pos[keep]
    with trace.span("add_points/wait"):
        n_valid = int(valid.sum())

    def sc(dst, src):
        out = dst.clone()
        with trace.span("add_points/wait"):
            rows = src[keep]
        out[idx] = rows.to(dst.dtype)
        return out

    return state.replace(
        xyz=sc(state.xyz, new["xyz"]),
        sh=sc(state.sh, new["sh"]),
        scaling=sc(state.scaling, new["scaling"]),
        rotation=sc(state.rotation, new["rotation"]),
        opacity=sc(state.opacity, new["opacity"]),
        confidence=sc(state.confidence, torch.zeros(M, device=dev)),
        add_tick=sc(state.add_tick, new["add_tick"]),
        depth_err_cnt=sc(state.depth_err_cnt, torch.zeros(M, device=dev)),
        color_err_cnt=sc(state.color_err_cnt, torch.zeros(M, device=dev)),
        frame_id=sc(state.frame_id, new["frame_id"]),
        obj_id=sc(state.obj_id, new["obj_id"]),
        sem_rgb=sc(state.sem_rgb, new["sem_rgb"]),
        status=sc(state.status, torch.full((M,), status_value, device=dev)),
        count=min(state.count + n_valid, state.capacity),
    )


def delete_points(state: MapState, mask: torch.Tensor) -> MapState:
    return state.replace(status=torch.where(mask, DEAD, state.status))


def promote_points(state: MapState, mask: torch.Tensor,
                   confidence_cap: float) -> MapState:
    """unstable -> stable, with the confidence clipped at the cap."""
    m = mask & (state.status == UNSTABLE)
    return state.replace(
        status=torch.where(m, STABLE, state.status),
        confidence=torch.where(
            m, torch.clamp(state.confidence, max=confidence_cap),
            state.confidence),
    )


def release_points(state: MapState, mask: torch.Tensor, time: int) -> MapState:
    """stable -> unstable, with the confidence reset."""
    m = mask & (state.status == STABLE)
    return state.replace(
        status=torch.where(m, UNSTABLE, state.status),
        confidence=torch.where(m, 0.0, state.confidence),
        add_tick=torch.where(m, int(time), state.add_tick),
    )


def compact(state: MapState) -> MapState:
    """Move the alive slots to the front, in slot order (frees dead slots)."""
    alive = state.status != DEAD
    with trace.span("compact/wait"):
        kept = torch.nonzero(alive)[:, 0]
    with trace.span("compact/wait"):
        freed = torch.nonzero(~alive)[:, 0]
    with trace.span("compact/wait"):
        n_alive = int(alive.sum())
    order = torch.cat([kept, freed])
    moved = {f: getattr(state, f)[order] for f in FIELDS}
    moved["status"][n_alive:] = DEAD
    return MapState(**moved, count=n_alive)


def grow(state: MapState, new_capacity: int) -> MapState:
    """Enlarge the capacity (rare)."""
    if new_capacity <= state.capacity:
        raise ValueError(f"grow to {new_capacity} <= {state.capacity}")
    pad = new_capacity - state.capacity

    def ext(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return MapState(**{f: ext(getattr(state, f), -1 if f == "obj_id" else 0)
                       for f in FIELDS}, count=state.count)
