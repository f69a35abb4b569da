"""What decides `correct`: the timed path's own outputs, recorded in the
window, against the plain reference (`slam_bench/reference/`), which
imports nothing of the port.

`Recorder.install` wraps a few of the system's calls, the seams that the
traffic file's `check.seams` names, on the first system the window
drives, so that they keep what they were given and what they returned
where the traffic file asks for it:

- the map render: the end-of-frame render of frame `Q` (the last
  `Mapping.get_render_output` of that frame, which `step` returns) and
  the map it was rendered from;
- the optimize scan: the scan that frame `Q` runs (`compact_optimize_scan`,
  the local or the keyframe scan), its inputs, its loss curve, and what
  its first masked Adam steps (`adam_update`) took and gave;
- tracking: ICP's inputs and its relative pose at the sampled frames;
- the object layer: every MODE=1 refinement (`refine_objects`) of the
  window's first pass, its inputs and its result; one at or before `Q`
  is required.

`compare` then works each of these out again with the reference, from the
frames the benchmark made and the program's state at that point (the map,
the previous frame's ICP pyramid, the scan's memory frames and schedule,
the objects' observations), and returns each number compared. The
configuration's file, not the program, gives the reference its settings,
learning rates and loss weights. With `lowered`, the reference itself
computes in the control's lower precision (`reference/precision.py`).
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import math
import statistics
import types
from types import SimpleNamespace

import numpy as np
import torch

from .reference import frame as ref_frame
from .reference import icp as ref_icp
from .reference import objects as ref_objects
from .reference import scan as ref_scan
from .reference.gaussian_map import FIELDS, MapState
from .reference.precision import lowered, rnd
from .reference.rasterize import RenderSettings
from .reference.renderer import render_state

SCAN_STEPS = 3          # the scan steps the reference follows
RENDER_KEYS = ("render", "depth", "depth_index_map")


def _clone_state(state) -> dict:
    return {f: getattr(state, f).detach().clone() for f in FIELDS} | {
        "count": int(state.count)}


def _bound(fn, a, kw) -> dict:
    """The arguments of a call to `fn` by their parameters' names, with
    the defaults filled in."""
    b = inspect.signature(fn).bind(*a, **kw)
    b.apply_defaults()
    return dict(b.arguments)


def resolve(seam: str, system):
    """(owner, attribute) of a seam the traffic file names: a module's
    function as `package.module:function`, or an attribute of the
    system's objects as `mapping.get_render_output`."""
    if ":" in seam:
        mod, name = seam.split(":")
        return importlib.import_module(mod), name
    *path, name = seam.split(".")
    owner = system
    for p in path:
        owner = getattr(owner, p)
    return owner, name


class Recorder:
    """Keeps, for one run, what `compare` needs. `frame` is the index of
    the frame `step` is working on, or -1 where nothing is recorded; the
    harness sets it before each step. `seams` names, by layer, the calls
    that are wrapped (`resolve`): the traffic file's `check.seams`. The
    wrappers take their arguments by name, so a seam that moves or changes
    its signature is named anew in a cell's traffic file."""

    def __init__(self, quality_frame: int, track_frames, want_objects: bool,
                 seams: dict):
        self.q = int(quality_frame)
        self.track_frames = set(int(f) for f in track_frames)
        self.want_objects = want_objects
        self.seams = dict(seams)
        self.frame = -1
        self.render = None          # {"cam", "state", "out"}
        self.scan = None            # {"args", "curve", "adam": [...]}
        self.tracks = {}            # frame -> {"vp0", "np0", "pose10"}
        self.objects = []           # [{"frame", "args", "rand_idx", "out"}]
        self.n_objects = 0          # the object layer's objects at the end
        self._adam_on = False
        self._undo = []

    def _wrap(self, layer: str, system, make):
        owner, name = resolve(self.seams[layer], system)
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig, name in vars(owner)))
        setattr(owner, name, make(orig))

    # -- the wrappers ------------------------------------------------------
    def install(self, system):
        rec = self

        def render(orig):
            def get_render_output(*a, **kw):
                if rec.frame == rec.q:
                    state = _clone_state(system.mapping.state)
                out = orig(*a, **kw)
                if rec.frame == rec.q:
                    cam = _bound(orig, a, kw)["cam_inputs"]
                    rec.render = {"cam": cam, "state": state,
                                  "out": {k: out[k].detach().clone()
                                          for k in RENDER_KEYS}}
                return out
            return get_render_output

        def scan(orig):
            def compact_optimize_scan(*a, **kw):
                armed = rec.frame == rec.q and rec.scan is None
                if armed:
                    b = _bound(orig, a, kw)
                    rec.scan = {"state": _clone_state(b["state"]),
                                "row_mask": b["row_mask"].clone(),
                                "frames": b["frames"],
                                "rand_idx": np.array(b["rand_idx"]),
                                "iters": b["iters"], "use_bg": b["use_bg"],
                                "adam": []}
                    rec._adam_on = True
                try:
                    out = orig(*a, **kw)
                finally:
                    rec._adam_on = False
                if armed:
                    rep = out[1]
                    rec.scan["curve"] = (
                        rep["total_loss"] + rep["scale_loss"]
                    ).detach().clone() if rep.get("iters") else None
                return out
            return compact_optimize_scan

        def adam(orig):
            def adam_update(*a, **kw):
                new_p, new_st = orig(*a, **kw)
                if rec._adam_on and len(rec.scan["adam"]) < SCAN_STEPS:
                    params = _bound(orig, a, kw)["params"]
                    rec.scan["adam"].append({
                        "p_in": {k: v.detach().clone()
                                 for k, v in params.items()},
                        "p_out": {k: v.detach().clone()
                                  for k, v in new_p.items()},
                        "m": {k: v.detach().clone()
                              for k, v in new_st.m.items()}})
                return new_p, new_st
            return adam_update

        def icp(orig):
            def icp_(*a, **kw):
                out = orig(*a, **kw)
                if rec.frame in rec.track_frames:
                    b = _bound(orig, a, kw)
                    rec.tracks[rec.frame] = {
                        "vp0": list(b["vp0"]), "np0": list(b["np0"]),
                        "pose10": out[0].detach().clone()}
                return out
            return icp_

        def objects(orig):
            def refine_objects(*a, **kw):
                out = orig(*a, **kw)
                if rec.want_objects and rec.frame >= 0:
                    b = _bound(orig, a, kw)
                    rec.objects.append({
                        "frame": rec.frame,
                        "args": [b[k].detach().clone() for k in (
                            "axes", "R", "center", "obs_bbox", "obs_P",
                            "obs_valid", "opt_mask")],
                        "rand_idx": np.array(b["rand_idx"]),
                        "out": [x.detach().clone() for x in out]})
                return out
            return refine_objects

        makers = {"render": render, "scan": scan, "adam": adam, "icp": icp,
                  "objects": objects}
        for layer in ("render", "scan", "adam", "icp") + (
                ("objects",) if self.want_objects else ()):
            self._wrap(layer, system, makers[layer])

    def uninstall(self):
        for owner, name, orig, own in reversed(self._undo):
            if own or isinstance(owner, types.ModuleType):
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._undo = []


# ---------------------------------------------------------------------------
# the reference's settings, from the configuration's file
# ---------------------------------------------------------------------------

def render_settings(config: dict, width: int, height: int):
    """(settings, the local scans' settings) as the configuration states
    them."""
    s = RenderSettings.from_args(width, height, SimpleNamespace(**config))
    us = s._replace(max_tiles_per_gaussian=int(
        config.get("local_max_tiles_per_gaussian", 8) or 8), chunk=128)
    return s, us


def scan_lrs(config: dict, keyframe: bool, device) -> dict:
    """The learning rates of the local scan, or of the keyframe scan (a
    tenth, positions fixed), with the SH's higher bands at a twentieth."""
    scale = 0.1 if keyframe else 1.0
    pos = 0.0 if keyframe else config["position_lr"]
    sh = torch.full((16, 1), config["feature_lr"] / 20.0 * scale,
                    device=device)
    sh[0] = config["feature_lr"] * scale
    return {"xyz": pos * scale, "sh": sh[None],
            "scaling": config["scaling_lr"] * scale,
            "rotation": config["rotation_lr"] * scale,
            "opacity": config["opacity_lr"] * scale,
            "sem_rgb": config["semantic_lr"]
            * config.get("semantic_lr_coef", 1.0) * scale}


def scan_weights(config: dict) -> dict:
    return {"color": config["color_weight"], "depth": config["depth_weight"],
            "normal": config["normal_weight"], "ssim": config["ssim_weight"],
            "semantic": config["semantic_color_weight"],
            "instance": config["instance_weight"]}


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------

def _state(d: dict) -> MapState:
    return MapState(**{f: rnd(d[f]) for f in FIELDS}, count=d["count"])


def render_numbers(rec: Recorder, config: dict, width: int,
                   height: int) -> dict:
    """The widest gap of the end-of-frame render's colour, and of its depth
    where both hit the same Gaussian, against the reference's render of
    the same map at the same camera; the share of pixels where one hits
    and the other does not."""
    r = rec.render
    settings, _ = render_settings(config, width, height)
    cam = {k: rnd(v) if torch.is_tensor(v) else v for k, v in r["cam"].items()}
    with torch.no_grad():
        ref = render_state(_state(r["state"]), cam, settings, "global")
    got = r["out"]
    same = ((got["depth_index_map"] >= 0)
            & (got["depth_index_map"] == ref["depth_index_map"]))
    dgap = torch.where(same, (got["depth"] - ref["depth"]).abs(), 0.0)
    hit_diff = (got["depth_index_map"] >= 0) != (ref["depth_index_map"] >= 0)
    return {"render_rgb_gap": float((got["render"] - ref["render"]).abs().max()),
            "render_depth_gap_m": float(dgap.max()),
            "render_hit_diff_share": float(hit_diff.float().mean())}


def _leaf_gaps(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the norms of the program's and the
    reference's tensors, over the larger of that leaf's reference norm and
    the median leaf's."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keep}
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep)


def scan_numbers(rec: Recorder, config: dict, width: int, height: int) -> dict:
    """The first scan steps: the first step's loss, the first gradient as
    the optimizer takes it (from its first moment after one step), and the
    parameters' change after `SCAN_STEPS` steps, against the reference's
    steps from the same state and inputs (each step's loss gap and each
    leaf's change gap are kept beside them, uncompared). A leaf whose reference gradient
    is under a thousandth of the median leaf's (round-off alone moves it
    under Adam) is left out of the change."""
    s = rec.scan
    if len(s["adam"]) < SCAN_STEPS or s["curve"] is None:
        raise RuntimeError(f"the scan of frame {rec.q} took "
                           f"{len(s['adam'])} steps, fewer than {SCAN_STEPS}")
    settings, usettings = render_settings(config, width, height)
    dev = s["row_mask"].device
    keyframe = not s["use_bg"]
    frames = {k: rnd(v) if torch.is_tensor(v) else v
              for k, v in s["frames"].items()}
    ref = ref_scan.compact_scan_steps(
        _state(s["state"]), s["row_mask"], frames, s["rand_idx"],
        scan_lrs(config, keyframe, dev), scan_weights(config),
        settings, settings if keyframe else usettings,
        config["add_depth_thres"], s["use_bg"], SCAN_STEPS)
    loss_p = [float(x) for x in s["curve"][:SCAN_STEPS]]
    loss_gaps = [abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(loss_p, ref["loss"])]
    g_prog = {k: v / (1 - 0.9) for k, v in s["adam"][0]["m"].items()}
    g_ref = ref["grad"]
    gn = {k: float(torch.linalg.vector_norm(v.double()))
          for k, v in g_ref.items()}
    med = statistics.median(gn.values())
    moved = [k for k, n in gn.items() if n >= 1e-3 * med]
    p0 = s["adam"][0]["p_in"]
    d_prog = {k: s["adam"][-1]["p_out"][k] - p0[k] for k in p0}
    d_ref = {k: ref["params"][-1][k] - ref["init"][k] for k in p0}
    lr = scan_lrs(config, keyframe, dev)
    changing = [k for k in moved
                if float(torch.as_tensor(lr[k]).abs().max()) > 0]
    return {"scan_loss_gap": loss_gaps[0],
            "scan_grad_gap": _leaf_gaps(g_prog, g_ref, moved),
            "scan_change_gap": _leaf_gaps(d_prog, d_ref, changing),
            "scan_loss_gaps_by_step": loss_gaps,
            "scan_change_gap_by_leaf": {
                k: _leaf_gaps(d_prog, d_ref, [k]) for k in changing}}


def track_numbers(rec: Recorder, config: dict, pool, K: np.ndarray,
                  device) -> dict:
    """The widest gap of ICP's relative pose at the sampled frames against
    the reference's ICP, which preprocesses the frame itself."""
    t = config
    cfg = ref_icp.IcpConfig(
        downscales=tuple(t["icp_downscales"]),
        iters=tuple(t["icp_downscale_iters"]),
        distance_threshold=t["icp_distance_threshold"],
        normal_threshold_cos=float(math.cos(math.radians(
            t["icp_normal_threshold"]))),
        damping=t["icp_damping"], fail_threshold=t["icp_fail_threshold"],
        min_valid_ratio=t.get("icp_min_valid_ratio", 0.3))
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)
    gap = 0.0
    for f, tr in sorted(rec.tracks.items()):
        j = f % len(pool)
        with torch.no_grad():
            fm = ref_frame.preprocess_frame(
                rnd(torch.as_tensor(pool.depths[j], device=device)),
                rnd(torch.as_tensor(pool.images[j], device=device)), Kt,
                levels=len(cfg.downscales), min_depth=t["min_depth"],
                max_depth=t["max_depth"],
                invalid_confidence_thresh=t["invalid_confidence_thresh"],
                depth_filter=t["depth_filter"])
            pose10, _, _ = ref_icp.icp_pyramid(
                [rnd(x) for x in tr["vp0"]], [rnd(x) for x in tr["np0"]],
                [rnd(x) for x in fm["vertex_pyr"]],
                [rnd(x) for x in fm["normal_pyr"]], Kt, cfg)
        gap = max(gap, float((tr["pose10"] - pose10).abs().max()))
    return {"track_pose_gap": gap}


def object_numbers(rec: Recorder) -> dict:
    """The widest gap of the refined objects (axes, rotation, centre) of
    every MODE=1 refinement recorded in the window against the
    reference's. The layer must have made objects and refined them at or
    before frame Q: a window with no refinement there compares nothing and
    is not correct."""
    if not rec.n_objects:
        raise RuntimeError("the object layer made no object in the window")
    if not any(o["frame"] <= rec.q for o in rec.objects):
        raise RuntimeError(f"no MODE=1 refinement ran at or before frame "
                           f"{rec.q} (refined at "
                           f"{[o['frame'] for o in rec.objects]})")
    gap = 0.0
    for o in rec.objects:
        a = [rnd(x) for x in o["args"]]
        out = ref_objects.refine_objects(*a, o["rand_idx"])
        mask = o["args"][6]
        for p, r in zip(o["out"], out):
            d = (p - r.detach()).abs()
            gap = max(gap, float(d[mask].max()) if bool(mask.any()) else 0.0)
    return {"objects_gap": gap,
            "objects_refined_at": [o["frame"] for o in rec.objects]}


def compare(rec: Recorder, layers, config: dict, pool, device,
            control: bool = False) -> dict:
    """Every number of the `layers` the traffic file names ("render",
    "scan", "track", "objects"), the reference in float32 with TF32 off,
    or, with `control`, in the control's lower precision."""
    K = np.array([[pool.fx, 0, pool.cx], [0, pool.fy, pool.cy], [0, 0, 1]],
                 np.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        with lowered() if control else contextlib.nullcontext():
            for layer in layers:
                if layer == "render":
                    if rec.render is None:
                        raise RuntimeError(f"frame {rec.q} left no "
                                           "end-of-frame render")
                    out.update(render_numbers(rec, config, pool.width,
                                              pool.height))
                elif layer == "scan":
                    if rec.scan is None:
                        raise RuntimeError(f"frame {rec.q} ran no scan")
                    out.update(scan_numbers(rec, config, pool.width,
                                            pool.height))
                elif layer == "track":
                    if len(rec.tracks) != len(rec.track_frames):
                        raise RuntimeError(
                            f"ICP ran on {sorted(rec.tracks)} of the "
                            f"sampled frames {sorted(rec.track_frames)}")
                    out.update(track_numbers(rec, config, pool, K, device))
                elif layer == "objects":
                    out.update(object_numbers(rec))
                else:
                    raise ValueError(f"unknown layer {layer!r}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, number, limit)]): each number that has a limit
    must be at most it; a number missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
