"""Keyframe data parallelism and object sharding over a list of devices
(counterpart of `dqo_map_tpu/parallel/dp.py`).

The JAX package shards its scans over a device mesh from one controller
(`shard_map` with a `psum`). The counterpart here is one process that
drives a list of devices, not one process per device: with a process per
device each would run the tracker and the mapper again, and the replicas
would drift apart under the atomics of the entry gather's backward.

- **Keyframe data parallelism** (`dp_optimize_scan`, `dp_optimize_step`):
  the batch of keyframes is split over the devices in order; each device
  holds a replica of the parameters and renders its keyframes, the shards'
  gradients are summed on the first device, the masked Adam step runs
  there and its parameters go back to every replica. Each step minimises
  the weighted mean loss over the whole batch, so N devices take the step
  one device takes over the same batch, up to the order of the sums.
- **Object sharding** (`shard_objects_refine`): the batched dual-quadric
  refinement (`models.quadrics.refine_objects`) split over the object
  axis, each device refining its slice.

On the CPU a mesh may list the CPU several times (virtual devices, the
counterpart of XLA's `xla_force_host_platform_device_count`), so the N-shard
arithmetic runs and is tested without cards. Copies between devices are
plain `Tensor.to` copies (peer copies between cards); on one device they
copy nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models.gaussian_map import FIELDS, MapState
from ..ops.rasterize import RenderSettings
from ..slam.mapper import (OPT_FIELDS, AdamState, _adam_scan, _grads,
                           _receipts, _substate, adam_update, image_loss,
                           scattered)

# the stacked frames' keys with one entry per frame (the rest are shared)
BATCHED = ("color", "depth", "normal", "render_mask", "tile_mask", "w2c",
           "full_proj", "cam_pos", "semantics_color", "instance_img")


@dataclass(frozen=True)
class Mesh:
    """The devices a scan's shards run on, the first the home of the
    Adam step and of the map."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of the first `n_devices` cards (`cuda:0..n-1`; by default
    every card), clipped to the cards there are; on the CPU, `n_devices`
    (by default 1) virtual devices, each the CPU."""
    kind = torch.device(device).type
    if kind != "cuda":
        return Mesh((torch.device(kind),) * (n_devices or 1))
    avail = torch.cuda.device_count()
    n = n_devices or avail
    if n > avail:
        print(f"[parallel] requested {n} devices but only {avail} "
              f"available; shrinking mesh")
        n = avail
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def dp_slots(entries: list, select_keyframe_num: Optional[int],
             n_devices: int):
    """The keyframe batch of a data-parallel scan and its slot weights, as
    the JAX package builds them (`dqo_map_tpu/slam/mapper.py:1514-1527`):
    on a keyframe scan (`select_keyframe_num` given) the last entry
    repeated up to `select_keyframe_num` slots, each slot weighing
    1 / slots, then repeats of weight 0 up to a multiple of `n_devices`.
    Returns (entries, weights)."""
    entries = list(entries)
    if select_keyframe_num is not None:
        while len(entries) < select_keyframe_num:
            entries.append(entries[-1])
    n_slots = len(entries)
    fweight = [1.0 / n_slots] * n_slots
    while len(entries) % n_devices != 0:
        entries.append(entries[-1])
        fweight.append(0.0)
    return entries, fweight


def _to(x, dev):
    return x.to(dev) if torch.is_tensor(x) else x


def _weighted_sum(reports: list, weights: list, home) -> dict:
    """sum_i weights[i] * reports[i], key by key, on `home`."""
    out = {}
    for r, w in zip(reports, weights):
        for k, v in r.items():
            v = v.detach().to(home) if torch.is_tensor(v) else v
            out[k] = out.get(k, 0.0) + w * v
    return out


class _Shard:
    """One device's share of the batch: its slots of nonzero weight (a
    slot of weight 0 adds exactly nothing to the loss or its gradient, so
    it is neither binned nor rendered), their frames and binnings on the
    device, and the loss of each."""

    def __init__(self, dev, sub: MapState, frames: dict, slots: list,
                 fweight: list, settings, subset, with_tile_mask, status_value,
                 weights, add_depth_thres, use_ssim):
        self.dev = dev
        self.slots = [f for f in slots if fweight[f] != 0.0]
        self.weights = [fweight[f] for f in self.slots]
        idx = torch.as_tensor(self.slots, dtype=torch.long)
        fr = {k: (v[idx.to(v.device)] if k in BATCHED else v)
              for k, v in frames.items()}
        self.frames = {k: _to(v, dev) for k, v in fr.items()}
        self.sub = MapState(**{f: getattr(sub, f).to(dev) for f in FIELDS},
                            count=sub.count)
        self.opt_mask = self.sub.status == status_value
        self.loss_of, self.binnings = ((None, []) if not self.slots else
                                       image_loss(self.sub, self.frames,
                                                  settings, subset,
                                                  with_tile_mask,
                                                  self.opt_mask, weights,
                                                  add_depth_thres, use_ssim))

    def value_and_grad(self, params: dict):
        """The shard's weighted loss report and its gradients at
        `params` (a replica on the shard's device)."""
        def loss_of(st, p):
            parts = [self.loss_of(st, i, p) for i in range(len(self.slots))]
            loss = sum(w * lo for w, (lo, _) in zip(self.weights, parts))
            return loss, _weighted_sum([r for _, r in parts], self.weights,
                                       self.dev)
        return _grads(self.sub, params, loss_of)


def _shards(mesh: Mesh, state: MapState, frames: dict, fweight, **kw):
    F = frames["w2c"].shape[0]
    if F % mesh.size != 0 or len(fweight) != F:
        raise ValueError(f"a batch of {F} frames with {len(fweight)} weights "
                         f"does not split over {mesh.size} devices")
    fweight = [float(w) for w in fweight]
    n = F // mesh.size
    sub = _substate(state, slice(0, state.count))
    return [_Shard(dev, sub, frames, list(range(d * n, (d + 1) * n)), fweight,
                   **kw) for d, dev in enumerate(mesh.devices)]


def _dp_value_and_grad(shards: list, home):
    """value_and_grad(params, it) of the whole batch: `params` (on `home`)
    copied to each shard's device, each shard's gradients there, their sum
    and the summed report back on `home`."""
    def value_and_grad(params, it):
        reports, grads = [], []
        for sh in shards:
            if not sh.slots:
                continue
            report, g = sh.value_and_grad(
                {k: v.to(sh.dev) for k, v in params.items()})
            reports.append(report)
            grads.append(g)
        total = {k: grads[0][k].to(home) for k in OPT_FIELDS}
        for g in grads[1:]:
            for k in OPT_FIELDS:
                total[k] = total[k] + g[k].to(home)
        return _weighted_sum(reports, [1.0] * len(reports), home), total
    return value_and_grad


def dp_optimize_scan(mesh: Mesh, state: MapState, frames: dict, fweight,
                     lrs: dict, weights, settings: RenderSettings,
                     iters: int, status_value: int, add_depth_thres: float,
                     subset: str = "stable", with_tile_mask: bool = True,
                     use_ssim: bool = False):
    """Data-parallel counterpart of `mapper.optimize_scan`
    (`dqo_map_tpu/parallel/dp.py:120-274`): `iters` masked Adam steps over
    the Gaussians of status `status_value`, each on the `fweight`-weighted
    loss summed over every stacked frame (the weights sum to 1; frames'
    leading dim a multiple of the mesh size, padded with weight-0 repeats),
    in image space, `subset` rendered with each frame's tile mask (or
    whole, `with_tile_mask=False`), SSIM in the loss with `use_ssim`, the
    semantic pass and the instance term where the frames carry their
    images.

    The frames are split over `mesh.devices` in order; each device bins
    its frames once, from the map as the scan starts. Every step, each
    device computes its weighted loss sum and gradients on its replica,
    the gradients are summed on the map's device, the masked Adam step and
    the confidence count run there, and the new parameters go back to the
    replicas. Returns (state, reports): the (iters,) curves of the weighted
    loss terms, `_receipts`' keys over every shard's binnings, `iters`,
    `sem_iters` and `blends` (the renders with gradient: each step one a
    live slot, two with the semantic pass)."""
    home = state.device
    shards = _shards(mesh, state, frames, fweight, settings=settings,
                     subset=subset, with_tile_mask=with_tile_mask,
                     status_value=status_value, weights=dict(weights),
                     add_depth_thres=add_depth_thres, use_ssim=use_ssim)
    sub = _substate(state, slice(0, state.count))
    opt_mask = sub.status == status_value
    params, confidence, reports = _adam_scan(
        sub, iters, lrs, opt_mask, _dp_value_and_grad(shards, home))
    with_sem = "semantics_color" in frames
    reports = _receipts(reports, [b for sh in shards for b in sh.binnings],
                        iters)
    live = sum(len(sh.slots) for sh in shards)
    reports["sem_iters"] = iters if with_sem else 0
    reports["blends"] = iters * live * (2 if with_sem else 1)
    return scattered(state, params, confidence), reports


def dp_optimize_step(mesh: Mesh, state: MapState, frames: dict,
                     opt_state: AdamState, lrs: dict, weights,
                     settings: RenderSettings, add_depth_thres: float,
                     status_value: int = 2):
    """One data-parallel Adam step (`dqo_map_tpu/parallel/dp.py:72-117`)
    on the mean loss over every stacked frame (leading dim a multiple of
    the mesh size), the whole map rendered whole at each. `opt_state`:
    `mapper.adam_init` of the first `state.count` rows of `OPT_FIELDS`.
    Returns (state, opt_state, loss)."""
    F = frames["w2c"].shape[0]
    shards = _shards(mesh, state, frames, [1.0 / F] * F, settings=settings,
                     subset="global", with_tile_mask=False,
                     status_value=status_value, weights=dict(weights),
                     add_depth_thres=add_depth_thres, use_ssim=False)
    sub = _substate(state, slice(0, state.count))
    params = {k: getattr(sub, k) for k in OPT_FIELDS}
    report, grads = _dp_value_and_grad(shards, state.device)(params, 0)
    with torch.no_grad():
        params, opt_state = adam_update(params, grads, opt_state, lrs,
                                        sub.status == status_value)
    loss = report["total_loss"] + report["scale_loss"]
    return scattered(state, params, sub.confidence), opt_state, loss


def shard_objects_refine(mesh: Mesh, axes, R, center, obs_bbox, obs_P,
                         obs_valid, opt_mask, rand_idx, iters: int = 20):
    """`refine_objects` with the object axis split over `mesh.devices` in
    order (its length a multiple of the mesh size), each device refining
    its slice with its columns of `rand_idx` (iters, O); the results
    concatenated on `axes`' device. Returns (axes, R, center)."""
    from ..models.quadrics import refine_objects
    O = axes.shape[0]
    if O % mesh.size != 0:
        raise ValueError(f"{O} objects do not split over {mesh.size} devices")
    n = O // mesh.size
    rand_idx = torch.as_tensor(rand_idx)
    outs = []
    for d, dev in enumerate(mesh.devices):
        s = slice(d * n, (d + 1) * n)
        outs.append(refine_objects(
            *(x[s].to(dev) for x in (axes, R, center, obs_bbox, obs_P,
                                     obs_valid, opt_mask)),
            rand_idx[:, s].to(dev), iters=iters))
    home = axes.device
    return tuple(torch.cat([o[k].to(home) for o in outs]) for k in range(3))
