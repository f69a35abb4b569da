"""Full SLAM checkpoint and resume (counterpart of
`dqo_map_tpu/utils/checkpoint.py`, with the same layout).

A checkpoint is `<path>.npz`, the map as `map_<field>` arrays (the JAX
package's names, `map_count` included) and the mapper's generator state,
plus `<path>.pkl`, the host bookkeeping: keyframes, memory frames, pose
lists, the scans' schedule generator, the recorder's means, the metrics
so far and the object layer (`ObjectLayer.state_dict`). The feature pose
backend's native state is not kept: after a resume the tracker primes a
fresh backend on the next frame, as after the first. Every tensor is
copied to host numpy, so a checkpoint holds no device memory;
`load_checkpoint` puts them back on the system's device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..models.gaussian_map import FIELDS, MapState
from ..models.quadrics import ObjectLayer

CKPT_VERSION = 1


def _tree_map(fn, tree):
    """`fn` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_host(tree):
    return _tree_map(lambda x: x.detach().cpu().numpy()
                     if isinstance(x, torch.Tensor) else x, tree)


def _to_device(tree, device):
    return _tree_map(lambda x: torch.as_tensor(x, device=device)
                     if isinstance(x, np.ndarray) else x, tree)


def save_checkpoint(path: str, system) -> str:
    """Write <path>.npz and <path>.pkl; returns the npz path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    m, t = system.mapping, system.tracker
    arrays = {f"map_{k}": getattr(m.state, k).detach().cpu().numpy()
              for k in FIELDS}
    arrays["map_count"] = np.int32(m.state.count)
    arrays["generator_state"] = m.generator.get_state().numpy()
    np.savez_compressed(path + ".npz", version=CKPT_VERSION, **arrays)

    host = {
        "version": CKPT_VERSION,
        "mapper": {
            "time": m.time, "iter": m.iter,
            "keyframe_ids": list(m.keyframe_ids),
            "optimize_frames_ids": list(m.optimize_frames_ids),
            "keyframes": [(kf[0].uid, _to_host(kf[1]), _to_host(kf[2]))
                          for kf in m.keyframes],
            "processed_frames": [(_to_host(c), _to_host(fm))
                                 for c, fm in m.processed_frames],
            "host_rng": m._host_rng.bit_generator.state,
        },
        "tracker": {
            "pose_es": t.poses_np(),
            "pose_gt": [np.asarray(p) for p in t.pose_gt],
            "timestamps": list(t.timestamps),
            "icp_fail_count": t.icp_fail_count,
        },
        "recorder": (dict(system.recorder.means),
                     dict(system.recorder.counts)),
        "metrics_history": list(system.metrics_history),
        "objects": (system.object_layer.state_dict()
                    if system.object_layer is not None else None),
    }
    with open(path + ".pkl", "wb") as f:
        pickle.dump(host, f)
    return path + ".npz"


def load_checkpoint(path: str, system) -> int:
    """Restore `system` in place from files this module wrote; returns the
    next frame id to process."""
    z = np.load(path + ".npz")
    if int(z["version"]) != CKPT_VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])}, "
                         f"expected {CKPT_VERSION}")
    m, dev = system.mapping, system.mapping.device
    m.state = MapState(**{k: torch.as_tensor(z[f"map_{k}"], device=dev)
                          for k in FIELDS}, count=int(z["map_count"]))
    m.generator.set_state(torch.as_tensor(z["generator_state"]))

    with open(path + ".pkl", "rb") as f:
        host = pickle.load(f)
    mp = host["mapper"]
    m.time, m.iter = mp["time"], mp["iter"]
    m.keyframe_ids = list(mp["keyframe_ids"])
    m.optimize_frames_ids = list(mp["optimize_frames_ids"])
    cam_by_uid = {c.uid: c for c in system.cameras}
    m.keyframes = [(cam_by_uid[uid], _to_device(cam, dev),
                    _to_device(keymap, dev))
                   for uid, cam, keymap in mp["keyframes"]]
    m.processed_frames = [(_to_device(c, dev), _to_device(fm, dev))
                          for c, fm in mp["processed_frames"]]
    m._host_rng.bit_generator.state = mp["host_rng"]
    m.model_map = None

    tr, t = host["tracker"], system.tracker
    t.pose_es = [np.asarray(p) for p in tr["pose_es"]]
    t.pose_gt = [np.asarray(p) for p in tr["pose_gt"]]
    t.timestamps = list(tr["timestamps"])
    t.icp_fail_count = tr["icp_fail_count"]
    # the next frame holds the last pose: its reference pyramid is not kept
    t._last_pyr = None
    t._curr_pyr = None
    t._pending_p2p = None

    means, counts = host["recorder"]
    system.recorder.means.update(means)
    system.recorder.counts.update(counts)
    system.metrics_history = list(host["metrics_history"])
    if host.get("objects") is not None:
        if system.object_layer is None:
            system.object_layer = ObjectLayer(system.cfg, dev)
        system.object_layer.load_state_dict(host["objects"])
    # the estimated poses back onto the cameras already consumed
    for fid, p in enumerate(t.pose_es):
        if fid < len(system.cameras):
            system.cameras[fid].update_pose(p)
    return m.time
