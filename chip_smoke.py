#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--frames 12] [--width 1200] [--height 680]

Path A is the main path of `bench.py`'s configuration (steps 1-5), path B
the semantic and instance supervision with the objects in MODE=0 (step
6), then the evaluation CLIs on path B's output (step 7), path C (step
8), path D, a Replica-layout sequence through the dataset
reader and the `run_slam` CLI (step 9), and the no-wait phase, ICP-only
tracking in loose sync under the sync debug mode (step 10).

1. Builds the two blend kernels, K1 forward (`dqo_map_tpu_torch/csrc/
   blend_fwd.cu`) and K2 backward (`csrc/blend_bwd.cu`), and K3,
   densification's exact KNN (`csrc/knn.cu`), with nvcc for sm_90a, one
   nvcc per source, all started together, printing what `-Xptxas -v`
   says of each kernel; then the feature pose backend
   (`runtime/orb_backend.cc`) and the JPEG decoder (`csrc/jpeg_decode.cc`)
   with g++ into `dqo_map_tpu_torch/_build/`. Then K3 at the benchmark's
   explore densify shapes (`knn_phase`): held rank by rank to a float64
   brute force and to its plain version (`knn2_ref`, the chunked
   `torch.topk` path it replaced), whose indices may differ only at the
   expansion's near-ties, its time per call by CUDA events with the L2
   flushed before each call, the search kernel's own device time, the
   plain version's time and the bound.
   After step 2, the same check and timing of K3 on the last densified
   frame's own inputs, and its launches there (`knn_path_a`).
2. Runs the port's main path, `SLAMSystem.run()`, in bench.py's
   configuration (bench.py:73-116) over synthetic RGB-D frames with
   detections at the benchmark's Replica office0 scale: 1200x680, 40,800
   samples a frame, map capacity 2^19, ICP fused with the feature backend
   on every frame (full resolution, hard keyframe override), the
   dual-quadric object layer (MODE=1), loose sync every 6 frames, and
   bench.py's 50 masked Adam steps on every 6th frame: the local scan
   (unstable Gaussians in front of the stable background) or, on a
   keyframe, the keyframe scan, then the objects' refinement; an
   evaluation at the first and the last frame; then the final
   whole-history pass (`final_global_iter` steps per keyframe over every
   keyframe, whole, with SSIM), the final evaluation, the trajectory, PLY
   map, `save_obj/` (objects and IoU), the instance and semantic colour
   passes and `performance.json` under `chiprun_out/run/`. The per-frame
   records come from a wrapper of `system.step`, the final pass's from a
   wrapper of `Mapping.global_optimization`, the colour passes' from one
   of `SLAMSystem.save_object_passes`, the backend's and the objects' host
   times from wrappers of `detect`, `track` and `optimize_objects`. Frames
   3-11 are the timed window, synchronised with the card at both ends.
   Where the frames give no keyframe, a second path runs the keyframe scan
   on the final map, as the next keyframe would; its launches are
   reported apart from the main path's. Each path zeroes the kernels'
   launch counters just before and reads them just after: K1 (both
   variants) must have launched once per model render (the evaluation
   renders included), scan iteration, stable-background render, keyframe
   range render and colour pass, K2 (both variants) once per scan
   iteration; each per-frame scan's objective must have fallen over its
   second half, the final pass must have run len(keyframes) x
   final_global_iter iterations, and its objective summed over every
   keyframe must have fallen from before the pass to after it (both sums
   under no_grad, their own K1 launches taken out of the counts). The
   mapper's `counts()` must have waited for the card on no frame after
   the first: no live read of the map, and no read of the snapshot queued
   at a frame's end (as the JAX package does) before that copy has
   landed (`check_count_reads`).
3. Holds each kernel against its plain version at the main path's shapes
   and times both: K1 on the final map at the last camera, K1's
   background variant and K2's background variant on the last local
   scan's last iteration, K2's plain variant on the last keyframe scan's
   last iteration, K1 and K2 on the final pass's last iteration
   (`blend_fwd_final`, `blend_bwd_final`: every tile live, SSIM's dense
   colour cotangent), and K1 at the colour-pass call site
   (`blend_fwd_colorpass`: the instance pass on the final map at the last
   camera, the object ids' palette colours in place of the SH colours).
   K1: index maps and n_touched exactly, float maps to 1e-5 (depth 1e-4).
   K2: each gradient row to 1e-4 of its largest magnitude (the CTA sums
   over the tile's pixels in another order), and the zero structure equal
   but at a few places of float32 cancellation (see `check_bwd`). A
   kernel's `ms` is its own device time per launch (the profiler's,
   `device_ms`), `wrapper_ms` the CUDA-event time of a whole wrapper call;
   for each kernel also the time with its tiles launched in tile order
   instead of the binning's `tile_order` (most entries first), and the
   most crowded tile's alone. Each row carries the live entries per
   non-empty tile of its call (`tile_entries`). Every recorded call must
   have come with the binning's `tile_order`.
   Then K4 (`csrc/project.cu`, `project_phase`), the render's
   per-Gaussian chain from the map's leaves to the blend's entry
   features and back, on the final map at the last camera: its geometry
   bit-equal to the plain `preprocess_ref`, its colours within rounding,
   its backward within 1e-5 of `project_bwd_ref` and as close to the plain
   chain's float64 autograd as its float32 autograd; each of its three
   kernels' device time a launch, their bytes' bound, the plain chain's
   time, forward and backward, and each kernel's launches over step 2's
   run, none of which may be 0.
   K4 replaces no Pallas kernel: the JAX package leaves the chain to XLA,
   which fuses it; the port's plain chain was ~1,200 small kernels an
   optimize step, nine tenths of its launches.
4. Checks the output: finite maps, every frame tracked with a known pose
   source, the render close to the frame, PSNR, depth-L1 and ATE before
   and after the final pass, at least one object, refined, with its IoU,
   and the files `run()` wrote.
5. Reloads the saved `_merge.ply` and renders it at the last camera
   against the saved state (colour to 1e-5, depth to 1e-4); saves a
   checkpoint and resumes it into a fresh system (map, keyframes, poses,
   time and object layer equal, the render at the last camera bit-equal);
   runs the `run_slam` CLI on 6 frames of `configs/synthetic/room.yaml`
   (object layer on) as a subprocess, which must exit 0 and write
   `result.json` with the reference CLI's keys.
6. Path B, beside path A (steps 2-5): `SLAMSystem.run()` over the same
   12 frames in `semantic_config` (`slice_config` with
   `configs/replica/office0_sem.yaml`'s semantic and instance terms, the
   objects in MODE=0) into `chiprun_out/run_sem/`. Each frame carries a
   semantic image, a class colour per wall and per ellipsoid of the room
   found by the room's own ray cast (`paint_semantics`, which checks its
   depth against the frame's bit for bit), and the same image as its
   instance image. Its launches are counted from 0: K1 and K2 twice a
   scan iteration (the colour and the semantic pass), K1 once more for
   each memory frame's semantic background in a local scan, 20 of each
   for every frame whose MODE=0 pass had objects, twice a final-pass
   iteration. The scans' objectives must fall (less the instance term,
   which no gradient reaches: the blend's T carries none), `sem_rgb` must
   have moved from the class colours it was sampled with, the semantic
   render must match the semantic image (mean error under 0.25 on the
   covered pixels) and the objects must have been refined. K1 and K2 are
   held against their plain versions there as in step 3, at the semantic
   pass's background variants on the last local scan's last iteration
   (`blend_fwd_sem`, `blend_bwd_sem`) and at the MODE=0 render of the
   last frame's objects on its last iteration (`blend_fwd_obj`,
   `blend_bwd_obj`).
7. The evaluation phase on path B's output, on the card, under
   `chiprun_out/eval/`: GT boxes and surface points written from the
   room's ellipsoids and walls; `metric_obj` in box mode and per object,
   `make_mesh` (TSDF fusion and marching tetrahedra along the run's
   trajectory, scored against the room), `ablate_assoc` on the synthetic
   sequence, and `per_object_mesh_eval` on the live map.
8. Path C (`run_path_c`): path A's frames with `parallel_enabled`, the
   keyframe scans and the final pass data-parallel over every card.
9. Path D, a real dataset's entry path: `read_jpeg` and `read_png`
   against PIL's hashes and modes of the committed fixtures
   (`tests/torch_fixtures/jpeg/`: baseline, progressive, Adobe RGB,
   arithmetic-coded, progressive with bits unsent, CMYK, YCCK, lossless;
   `tests/torch_fixtures/png/`: palette, 1-, 2- and 4-bit grey, Adam7),
   the palette, 1-bit and CMYK ones also resized by `resize_like_pil`
   against PIL's resize, `encode_jpeg` against PIL's files of the
   encoder's input at quality 75 and 85 (4:2:0 and grey), byte for byte,
   with the times of `read_jpeg` on the 1200x680 room (progressive,
   arithmetic-coded, progressive ended after its 4th scan) and of
   `encode_jpeg` on it; path A's
   frames written in Replica's layout under `chiprun_out/replica/`
   (`results/frame%06d.jpg` through `write_jpeg` at quality 95, 4:2:0,
   PIL's encoder's bytes,
   `results/depth%06d.png` 16-bit at Replica's scale 6553.5, `traj.txt`,
   `../cam_params.json`); the port's Replica reader must return the
   depth exactly and the colour at least 40 dB from its source; then the
   `run_slam` CLI as a subprocess on a child of
   `configs/replica/office0.yaml` over those 12 frames, into
   `chiprun_out/run_replica/`: it must exit 0, write `result.json` and
   the trajectory, and launch K1 and K2, both variants. Prints the
   decoder's and the resize's host times, path D's `run()` seconds and
   its quality at frame 11 beside path A's.
10. The no-wait phase (`nowait_phase`): path A's configuration without
   the feature backend, loose sync, 6 frames through `SLAMSystem.step`;
   from frame 2 on the tracker's `map_preprocess` and `tracking` run
   under `torch.cuda.set_sync_debug_mode("error")`, so a synchronising
   call there fails the run. Prints the tracking stage's host ms a frame
   and on how many frames tracking returned before its residual's host
   copy had landed.

The port's device time by kernel and its idle share come from the
benchmark's traced run (`slam_bench/run.py --trace 1`), not from here.

Prints the card, per-frame times (host times on the frames that do not
sync), the timed window, the backend's and the objects' numbers, map and
entry counts, PSNR, depth-L1 and ATE at the last frame, the final pass's
counts, times and quality, path B's counts and checks and the evaluation
phase's numbers, each report line with the card's name and power limit,
then one JSON line of kernel numbers (path A's rows, then path B's) and,
last, the JSON result line. Exits non-zero, before printing a result,
without a CUDA card or when any check fails.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (data sheet)
PEAK_F32_PER_S = 67e12        # H100 SXM FP32, outside the tensor cores
# float operations per (pixel, entry) pair each kernel walks
OPS_FWD = 28
OPS_FWD_BG = 36
OPS_BWD = 62
WARMUP_FRAMES = 3
# K3 at explore's densify shapes: `add_capacity` new points, first among
# the candidates, then the map's slots up to its watermark (53-61k at the
# quality frame, PERF.md section 4); k as `densify_step` asks
KNN_M = 98_304
KNN_N = 155_000
KNN_K = 8
KNN_OPS = 8                   # a pair: 3 subtractions, 3 products, 2 sums
KNN_REL = 1e-6                # K3's own rounding, of the distance
KNN_EXPANSION_ROUNDING = 2e-6  # the plain version's, of |q|^2 + |c|^2
KNN_REPS = 20
L2_FLUSH_BYTES = 256 << 20    # well over the H100's 50 MB L2
ADAM_STEPS = 50               # bench.py:111's gaussian_update_iter
# K2 against its plain version: the places where exactly one of the two
# is 0 (a sum of +-c cancelling exactly in one order and to a rounding
# residue in the other) may number at most MAX_FLIPS, each off by at most
# FLIP_TOL of its row's largest magnitude, a few float32 ulps
MAX_FLIPS = 32
FLIP_TOL = 1e-6
KERNELS = ("blend_fwd", "blend_fwd_bg", "blend_bwd", "blend_bwd_bg")
FINAL_ROWS = ("blend_fwd_final", "blend_bwd_final")
COLOR_PASSES = 2              # the instance and the semantic pass of run()
POSE_SOURCES = ("keyframe", "features", "icp", "hold")
REPLACES = {
    "blend_fwd": "dqo_map_tpu/ops/blend_pallas.py:179",
    "blend_fwd_bg": "dqo_map_tpu/ops/blend_pallas.py:220",
    "blend_bwd": "dqo_map_tpu/ops/blend_pallas.py:366",
    "blend_bwd_bg": "dqo_map_tpu/ops/blend_pallas.py:366",
    "blend_fwd_final": "dqo_map_tpu/ops/blend_pallas.py:179",
    "blend_bwd_final": "dqo_map_tpu/ops/blend_pallas.py:366",
    "blend_fwd_colorpass": "dqo_map_tpu/ops/blend_pallas.py:179",
    "blend_fwd_sem": "dqo_map_tpu/ops/blend_pallas.py:220",
    "blend_bwd_sem": "dqo_map_tpu/ops/blend_pallas.py:366",
    "blend_fwd_obj": "dqo_map_tpu/ops/blend_pallas.py:179",
    "blend_bwd_obj": "dqo_map_tpu/ops/blend_pallas.py:366",
    "blend_fwd_dp": "dqo_map_tpu/ops/blend_pallas.py:179",
    "blend_bwd_dp": "dqo_map_tpu/ops/blend_pallas.py:366",
}
PATH_B_ROWS = ("blend_fwd_sem", "blend_bwd_sem", "blend_fwd_obj",
               "blend_bwd_obj")
PATH_C_ROWS = ("blend_fwd_dp", "blend_bwd_dp")
# path B's semantic classes: the six walls of the synthetic room, then its
# ellipsoids, one colour each
CLASS_COLOURS = np.array([
    [0.90, 0.10, 0.10], [0.10, 0.90, 0.10], [0.10, 0.10, 0.90],
    [0.90, 0.90, 0.10], [0.90, 0.10, 0.90], [0.10, 0.90, 0.90],
    [0.95, 0.55, 0.10], [0.55, 0.10, 0.95], [0.10, 0.55, 0.35],
    [0.55, 0.55, 0.55]], np.float32)
RUN_DIR = os.path.join("chiprun_out", "run")
RUN_B_DIR = os.path.join("chiprun_out", "run_sem")
RUN_C_DIR = os.path.join("chiprun_out", "run_dp")
EVAL_DIR = os.path.join("chiprun_out", "eval")
CLI_DIR = os.path.join("chiprun_out", "cli")
# path D: the room in Replica's layout (`office0/` and `cam_params.json`
# beside it) and the run on it
REPLICA_DIR = os.path.join("chiprun_out", "replica")
RUN_D_DIR = os.path.join("chiprun_out", "run_replica")
REPLICA_SCALE = 6553.5        # Replica's depth scale (its cam_params.json)
JPEG_FIXTURES = os.path.join("tests", "torch_fixtures", "jpeg")
PNG_FIXTURES = os.path.join("tests", "torch_fixtures", "png")
ROOM_PROGRESSIVE = "room_prog_q75_1200x680.jpg"
ROOM_ARITH = "room_arith_q75_1200x680.jpg"
ROOM_SMOOTH = "room_prog_cut4_q75_1200x680.jpg"
# the no-wait phase: path A without the feature backend, its tracking
# under the sync debug mode from this frame on
NOWAIT_DIR = os.path.join("chiprun_out", "run_nowait")
NOWAIT_FRAMES = 6
NOWAIT_FROM = 2
# the card's spin queued before each guarded `tracking` call, ~1 s at the
# H100's 1980 MHz: longer than the call's host time by some 10x
NOWAIT_SLEEP_CYCLES = 2_000_000_000
MIN_JPEG_PSNR = 40.0          # the written colour against its source, dB
# the run_slam CLI as `python -m dqo_map_tpu_torch.cli.run_slam` runs it
# (its arguments after the code), its `run()` timed to the card's end,
# then the kernels' launch counts of the whole process
RUN_SLAM_COUNTED = """
import json, runpy, time
import torch
from dqo_map_tpu_torch.ops import blend_cuda
from dqo_map_tpu_torch.slam.system import SLAMSystem
inner, seconds = SLAMSystem.run, []
def run(self, *a, **kw):
    t0 = time.perf_counter()
    out = inner(self, *a, **kw)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    return out
SLAMSystem.run = run
runpy.run_module("dqo_map_tpu_torch.cli.run_slam", run_name="__main__",
                 alter_sys=True)
print("RUN_S " + json.dumps(seconds))
print("LAUNCHES " + json.dumps(blend_cuda.LAUNCHES))
"""
# the keys of the reference CLI's result.json (`dqo_map_tpu/cli/run_slam.py`
# over `SLAMSystem.run`, with the object layer's receipts)
RESULT_KEYS = {"psnr", "ssim", "ms_ssim", "color_l1", "depth_l1_cm",
               "valid_ratio", "lpips", "lpips_note", "ate_cm", "fps",
               "max_mem_GB", "mean_tracking_s", "mean_mapping_s",
               "n_objects", "obj_obs_trimmed", "obj_over_cap"}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def slice_config(save_path: str = RUN_DIR, **extra):
    from dqo_map_tpu_torch.config import default_config
    # bench.py's workload (bench.py:73-116): the object layer, the feature
    # backend at full resolution with the hard keyframe override, loose
    # sync every 6 frames
    return default_config(**extra,
        type="Synthetic", save_path=save_path, use_object=True,
        use_gt_pose=False,
        icp_use_model_depth=False, use_orb_backend=True, orb_downsample=1,
        orb_kf_gain=1.0,
        capacity=1 << 19, add_capacity=16384,
        uniform_sample_num=40800, gaussian_update_frame=6,
        gaussian_update_iter=ADAM_STEPS, stable_confidence_thres=20,
        global_keyframe_num=3, min_depth=0.1, max_depth=8.0,
        memory_length=5, sync_tracker2mapper_method="loose",
        sync_tracker2mapper_frames=6)


def semantic_config(save_path: str = RUN_B_DIR):
    """Path B: `slice_config` with `configs/replica/office0_sem.yaml`'s
    semantic and instance supervision and the objects in MODE=0."""
    return slice_config(save_path, use_semantics=True, use_instance=True,
                        semantic_color_weight=0.1, instance_weight=0.8,
                        object_mode=0)


class Recorder:
    """Keeps the arguments of each kernel variant's last launch, to hold
    the kernels against their plain versions at the main path's shapes;
    the launches of the final pass under the `_final` names (`phase`), and
    none while `phase` is None. Path B's and path C's call sites are
    tagged (`tag`): while a tag is set, K1's launches of its variant
    (`TAGS`: the semantic pass's with the background, MODE=0's and the
    data-parallel scans' without) are kept and counted under
    `blend_fwd<tag>`, and K2's launch on the colour block such a K1 launch
    returned under `blend_bwd<tag>`, whatever the phase."""

    TAGS = {"_sem": True, "_obj": False, "_dp": False}   # tag -> with bg

    def __init__(self):
        from dqo_map_tpu_torch.ops import blend_cuda
        self.mod = blend_cuda
        self.fwd, self.bwd = blend_cuda.blend_fwd, blend_cuda.blend_bwd
        self.last = {}
        self.phase = ""
        self.tag = None
        self.tagged = {}                    # blend_{fwd,bwd}<tag> -> launches
        self._colour_tags = {}              # K1 colour block pointer -> tag

    def _keep(self, name, a, kw, tag=None):
        if tag is not None:
            self.last[name + tag] = (a, kw)
            self.tagged[name + tag] = self.tagged.get(name + tag, 0) + 1
        elif self.phase is not None:
            self.last[name + self.phase] = (a, kw)

    def __enter__(self):
        def fwd(*a, **kw):
            bg = kw.get("bgt") is not None
            out = self.fwd(*a, **kw)
            tag = self.tag if self.TAGS.get(self.tag) == bg else None
            if tag:
                self._colour_tags[out[0].data_ptr()] = tag
                self._keep("blend_fwd", a, kw, tag)
            else:
                self._colour_tags.pop(out[0].data_ptr(), None)
                self._keep("blend_fwd_bg" if bg else "blend_fwd", a, kw)
            return out

        def bwd(*a, **kw):
            bg = kw.get("bgt") is not None
            tag = self._colour_tags.get(a[9].data_ptr())
            if tag:
                self._keep("blend_bwd", a, kw, tag)
            else:
                self._keep("blend_bwd_bg" if bg else "blend_bwd", a, kw)
            return self.bwd(*a, **kw)

        self.mod.blend_fwd, self.mod.blend_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.mod.blend_fwd, self.mod.blend_bwd = self.fwd, self.bwd


def launches_now() -> dict:
    from dqo_map_tpu_torch.ops.blend_cuda import LAUNCHES
    return dict(LAUNCHES)


def reset_launches():
    from dqo_map_tpu_torch.ops.blend_cuda import reset_launches as reset
    reset()


def check_launches(what: str, got: dict, scans0: dict, scans1: dict,
                   renders: int, color_passes: int = 0, obj_iters: int = 0):
    """K1 once per model render, scan iteration, semantic pass (one an
    iteration where the frames carry semantics), background render (colour
    and semantic), range render, colour pass and MODE=0 object iteration;
    K2 once per scan iteration, semantic pass and object iteration. The
    host launches a graphed scan step's blends once, at its capture: its
    replays launch them on the card alone (`replayed_blends`)."""
    d = {k: scans1[k] - scans0[k] for k in scans1}
    # a scan's blends with gradient: one an iteration, two with the
    # semantic pass, one a live keyframe slot an iteration when
    # data-parallel
    want_bwd = d["blends"] - d["replayed_blends"] + obj_iters
    want_fwd = (renders + want_bwd + d["bg_renders"] + d["sem_bg_renders"]
                + d["range_renders"] + color_passes)
    fwd = got["blend_fwd"] + got["blend_fwd_bg"]
    bwd = got["blend_bwd"] + got["blend_bwd_bg"]
    print(f"{what}: launches {got}; model renders {renders}, scans "
          f"local {d['local']} keyframe {d['global']} final {d['final']}, "
          f"iterations {d['iters']} (with the semantic pass "
          f"{d['sem_iters']}; blends {d['blends']}), background renders "
          f"{d['bg_renders']} "
          f"(semantic {d['sem_bg_renders']}), range renders "
          f"{d['range_renders']}, colour passes {color_passes}, MODE=0 "
          f"object iterations {obj_iters}")
    if fwd != want_fwd or bwd != want_bwd:
        raise RuntimeError(f"{what}: K1 launched {fwd} times for {want_fwd} "
                           f"blends, K2 {bwd} times for {want_bwd} "
                           "iterations")


def check_scans_fall(mapping, start: int, untrained=None,
                     kinds=("local", "global")):
    """Each per-frame scan's objective at its last iteration below that at
    iteration iters//2 + 1, where the schedule pins the newest frame (the
    final pass pins none: `FinalPass` checks it), for the scans of
    `kinds`. `untrained[i]`, where given, is the weighted curve of a term
    that no gradient reaches (the instance term: the blend's T carries
    none), taken out of scan i's."""
    for i, (kind, curve) in enumerate(mapping.scan_log[start:]):
        if kind not in kinds:
            continue
        if untrained is not None:
            curve = curve - untrained[start + i]
        c = curve.tolist()
        mid = len(c) // 2 + 1
        if mid < len(c) - 1 and not c[-1] < c[mid]:
            raise RuntimeError(f"{kind} scan did not optimise: objective "
                               f"{c[mid]} at iteration {mid}, {c[-1]} at "
                               f"the last")
        print(f"  {kind} scan: objective {c[0]:.5f} -> {c[mid]:.5f} "
              f"(iteration {mid}) -> {c[-1]:.5f}")


def pass_objective(m, state, masks, init_stat) -> float:
    """The final pass's objective at `state`, summed over every keyframe:
    its loss (colour and SSIM terms, no depth term, the semantic term where
    the keyframes keep a semantic image, and the attach term against
    `init_stat`) of the stable render in each keyframe's render mask
    `masks[i]`."""
    import torch
    from dqo_map_tpu_torch.models import gaussian_map as gm
    from dqo_map_tpu_torch.slam.mapper import OPT_FIELDS, compute_loss
    from dqo_map_tpu_torch.slam.renderer import render_state
    B = state.count
    params = {k: getattr(state, k)[:B] for k in OPT_FIELDS}
    opt_mask = state.status[:B] == gm.STABLE
    weights = dict(m._weights_t(depth=0.0))
    total = 0.0
    with torch.no_grad():
        for (_, cam, keymap), rm in zip(m.keyframes, masks):
            out = render_state(state, cam, m.settings, "stable")
            image_input = {"color_map": keymap["color"],
                           "depth_map": keymap["depth"],
                           "normal_map": keymap["normal"], "render_mask": rm}
            sem = None
            if "semantics" in keymap:
                image_input["semantics_color"] = keymap["semantics"]
                sem = render_state(state, cam, m.settings, "stable",
                                   colors_precomp=state.sem_rgb)["render"]
            # no instance term: the blend's T carries no gradient, so the
            # pass cannot lower it
            loss, _ = compute_loss(out, image_input, params, init_stat,
                                   opt_mask, weights, m.args.add_depth_thres,
                                   True, sem_render=sem)
            total += float(loss)
    return total


class FinalPass:
    """Wraps `Mapping.global_optimization`. On the final pass it records
    the pass objective summed over every keyframe before and after the
    pass (`pass_objective`; their K1 launches taken back out of the
    counts), the ATE before it, its wall time, the scan counts and kernel
    launches it made; the recorder keeps its kernel calls under the
    `_final` names."""

    def __init__(self, system, rec, phase="_final"):
        self.system, self.rec = system, rec
        self.phase = phase
        self.m = system.mapping
        self.inner = self.m.global_optimization
        self.info = None

    def _uncounted(self, fn):
        """`fn()`, its kernel launches neither counted nor recorded; their
        number is kept in `info["uncounted_launches"]`."""
        from dqo_map_tpu_torch.ops.blend_cuda import LAUNCHES
        saved, phase = dict(LAUNCHES), self.rec.phase
        self.rec.phase = None
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.rec.phase = phase
            self.info["uncounted_launches"] += sum(
                LAUNCHES[k] - saved[k] for k in LAUNCHES)
            self.info["uncounted_s"] += time.perf_counter() - t0
            LAUNCHES.update(saved)

    def __call__(self, select_keyframe_num: int = -1):
        if select_keyframe_num != -1:
            return self.inner(select_keyframe_num)
        import torch
        from dqo_map_tpu_torch.slam.mapper import (gaussians_fix,
                                                   render_range_step)
        m = self.m
        self.info = {"keyframes": len(m.keyframes), "uncounted_launches": 0,
                     "uncounted_s": 0.0,
                     "ate_before_cm": self.system.tracker.eval_ate_series()}
        # the state, render masks and anchors the pass starts from
        start = gaussians_fix(m.state, -1.0)
        masks = self._uncounted(lambda: [
            render_range_step(start, cam, m.settings, True, -1.0,
                              keymap["color"], m.settings.tile_size)[0]
            for _, cam, keymap in m.keyframes])
        init_stat = {k: getattr(start, k)[:start.count]
                     for k in ("opacity", "scaling", "xyz", "rotation")}
        before = self._uncounted(
            lambda: pass_objective(m, start, masks, init_stat))
        scans0 = dict(m.scan_counts)
        launches0 = launches_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outer, self.rec.phase = self.rec.phase, self.phase
        try:
            self.inner()
        finally:
            self.rec.phase = outer
        torch.cuda.synchronize()
        self.info["seconds"] = time.perf_counter() - t0
        after_launches = launches_now()
        self.info["launches"] = {k: after_launches[k] - launches0[k]
                                 for k in after_launches}
        self.info["scans"] = {k: m.scan_counts[k] - scans0[k]
                              for k in m.scan_counts}
        self.info["objective"] = (before, self._uncounted(
            lambda: pass_objective(m, m.state, masks, init_stat)))


def timed(obj, name: str, log: dict):
    """Wrap the method `name` of `obj` to append the wall seconds of each
    call to `log[name]`; `del obj.<name>` takes the wrapper off."""
    inner = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            log.setdefault(name, []).append(time.perf_counter() - t0)

    setattr(obj, name, wrapper)


class ColorPasses:
    """Wraps `SLAMSystem.save_object_passes`: the kernel launches of the
    instance and semantic passes (the recorder keeps none of them), and
    their wall time."""

    def __init__(self, system, rec):
        self.system, self.rec = system, rec
        self.inner = system.save_object_passes
        self.launches, self.seconds = None, None

    def __call__(self, frame):
        import torch
        phase, self.rec.phase = self.rec.phase, None
        launches0 = launches_now()
        t0 = time.perf_counter()
        try:
            return self.inner(frame)
        finally:
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            self.rec.phase = phase
            after = launches_now()
            self.launches = {k: after[k] - launches0[k] for k in after}


def run_main_path(args, device, rec):
    """`SLAMSystem.run()` over `args.frames` frames. Returns (system,
    cameras, per-frame infos, the final pass's `FinalPass.info`, the run's
    result, the seconds of its evaluations and exports, launches,
    seconds, the timed window, the host-side logs, the colour passes,
    K3's launches a densified frame with the last frame's search inputs,
    K4's launches)."""
    import torch
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    t0 = time.perf_counter()
    _, cams = synthetic_sequence(args.frames, width=args.width,
                                 height=args.height, with_detections=True)
    print(f"frames: {args.frames} at {args.width}x{args.height}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    system = SLAMSystem(slice_config(), cameras=cams, device=device)
    m = system.mapping
    backend = system.tracker.pose_backend
    infos = []
    window = {}
    inner_step = system.step

    def step(cam, i):
        if i == WARMUP_FRAMES:
            torch.cuda.synchronize(device)
            window["t0"] = time.perf_counter()
        info = inner_step(cam, i)
        if i == args.frames - 1:
            torch.cuda.synchronize(device)
            window["t1"] = time.perf_counter()
        info["optimized"] = m.did_optimize
        info["live_count_reads"] = m.live_count_reads
        info["waited_count_reads"] = m.waited_count_reads
        info["source"] = backend.source_last
        infos.append(info)
        return info

    system.step = step
    final = FinalPass(system, rec)
    m.global_optimization = final
    passes = ColorPasses(system, rec)
    system.save_object_passes = passes
    tail, host = {}, {}
    for obj, name in ((system, "_eval"), (system.tracker, "save_traj"),
                      (m, "save_model")):
        timed(obj, name, tail)
    for obj, name in ((backend, "detect"), (backend, "track"),
                      (system.object_layer, "optimize_objects")):
        timed(obj, name, host)
    # K3 once a densified frame: its launches within each call, and the
    # last call's inputs, for knn_path_a
    from dqo_map_tpu_torch.ops import knn
    from dqo_map_tpu_torch.slam import mapper as mapper_mod
    densify, search = mapper_mod.densify_step, mapper_mod.knn2
    k3 = {"calls": [], "inputs": None}

    def counted_densify(*a, **kw):
        before = dict(knn.LAUNCHES)
        out = densify(*a, **kw)
        k3["calls"].append({k: knn.LAUNCHES[k] - before[k] for k in before})
        return out

    def kept_search(*a, **kw):
        k3["inputs"] = ([x.clone() for x in a[:4]], a[4:], dict(kw))
        return search(*a, **kw)

    mapper_mod.densify_step = counted_densify
    mapper_mod.knn2 = kept_search
    from dqo_map_tpu_torch.ops import project_cuda
    scans0 = dict(m.scan_counts)
    reset_launches()
    project_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        with rec:
            result = system.run(eval_every=args.frames, verbose=False)
    finally:
        mapper_mod.densify_step, mapper_mod.knn2 = densify, search
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = launches_now()
    # K4 on every render, binning and coverage mask of the run; its
    # backward once an eager scan step (a graph's replays launch none)
    k4 = dict(project_cuda.LAUNCHES)
    print(f"K4 on the main path: launches {k4}")
    if not all(k4.values()):
        raise RuntimeError(f"the main path launched K4 {k4}, wanted each "
                           "of its kernels at least once")
    calls = k3["calls"]
    print(f"K3 on the main path: {len(calls)} densified frames, launches "
          f"{ {k: sum(c[k] for c in calls) for k in knn.LAUNCHES} }")
    if not calls or any(c != {"knn_pack": 1, "knn": 1} for c in calls):
        raise RuntimeError(f"densification launched K3 {calls}, wanted "
                           "the pack and the search once a frame")
    del system.step, m.global_optimization      # the wrappers
    del system._eval, system.tracker.save_traj, m.save_model
    del system.save_object_passes, backend.detect, backend.track
    del system.object_layer.optimize_objects
    if passes.launches is None:
        raise RuntimeError("run() ran no colour pass")
    if passes.launches["blend_fwd"] != COLOR_PASSES or \
            sum(passes.launches.values()) != COLOR_PASSES:
        raise RuntimeError(f"the colour passes launched {passes.launches}, "
                           f"wanted K1 {COLOR_PASSES} times")
    check_launches("main path", launches, scans0, m.scan_counts, m.renders,
                   COLOR_PASSES)
    check_scans_fall(m, 0)
    if final.info is None:
        raise RuntimeError("run() ran no final pass")
    return (system, cams, infos, final.info, result, tail, launches, seconds,
            window, host, passes, k3, k4)


def check_count_reads(infos, m):
    """The mapper's `counts()` waits for the card in two ways: a live read
    of the map, a wait for all the work queued, made only before the
    first frame (and where the JAX package drops its snapshot: after the
    final pass's promotion, when no queued copy waits); and a read of the
    snapshot queued at a frame's end before that copy has landed, a wait
    for the previous frame's tail. Path A's frames after the first must
    make neither."""
    live = [i["live_count_reads"] for i in infos]
    waited = [i["waited_count_reads"] for i in infos]
    print(f"mapper counts(): live reads of the map {live[0]} on frame 0, "
          f"{live[-1] - live[0]} on frames 1-{len(live) - 1}, "
          f"{m.live_count_reads - live[-1]} in the final pass; snapshot "
          f"reads that waited for their copy {waited[0]} on frame 0, "
          f"{waited[-1] - waited[0]} on frames 1-{len(waited) - 1}, "
          f"{m.waited_count_reads - waited[-1]} in the final pass")
    if live[-1] != live[0] or waited[-1] != waited[0]:
        raise RuntimeError(f"the mapper's counts() waited for the card after "
                           f"the first frame: live {live}, waited {waited}")


def keyframe_phase(system, device, rec) -> dict:
    """The keyframe scan on the final map over the newest keyframes, the
    pass the next keyframe takes, when the frames gave none. Returns its
    own launches."""
    import torch
    m = system.mapping
    scans0, n_log = dict(m.scan_counts), len(m.scan_log)
    reset_launches()
    t0 = time.perf_counter()
    with rec:
        m.global_optimization(system.cfg.map.global_keyframe_num)
    torch.cuda.synchronize(device)
    launches = launches_now()
    print(f"keyframe phase: {1e3 * (time.perf_counter() - t0):.1f} ms")
    check_launches("keyframe phase", launches, scans0, m.scan_counts, 0)
    check_scans_fall(m, n_log)
    return launches


def quality(system, cams, infos, min_depth=0.1, max_depth=8.0) -> dict:
    """PSNR and depth-L1 of the last end-of-frame render against its frame
    (the reference's `eval_picture` definitions) and the trajectory ATE."""
    import torch
    from dqo_map_tpu_torch.utils.losses import psnr
    out = infos[-1]["render"]
    for k in ("render", "depth", "T_map", "normal"):
        if not bool(torch.isfinite(out[k]).all()):
            raise RuntimeError(f"non-finite values in the render's {k}")
    dev = out["render"].device
    gt = torch.as_tensor(cams[-1].image, device=dev)
    gtd = torch.as_tensor(cams[-1].depth, device=dev)
    gtd = torch.where((gtd > min_depth) & (gtd < max_depth), gtd, 0.0)
    invalid = (out["depth_index_map"] == -1) | (gtd == 0)
    derr = torch.where(invalid, 0.0, torch.abs(gtd - out["depth"]))
    depth_l1_cm = float(derr.sum() / torch.clamp((~invalid).sum(), min=1)) * 100
    return {"psnr": float(psnr(out["render"], gt)), "depth_l1_cm": depth_l1_cm,
            "ate_cm": system.tracker.eval_ate_series(),
            "icp_fail_count": system.tracker.icp_fail_count}


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call of `fn` over `reps` calls, by CUDA events, after
    one untimed call: the wrapper's whole window, its other launches and
    the host's pace included."""
    import torch
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, symbol: str, reps: int) -> float:
    """Mean device time in ms of one launch of the kernel whose name holds
    `symbol`, over `reps` calls of `fn` after one untimed call: the
    profiler's own device time of that kernel, so neither the wrapper's
    other launches nor the host's pace count. The profiler can lose some
    kernel records in a long process; the mean is over those it kept, and
    a window that kept fewer than half is measured again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and symbol in e.key]
        n = sum(e.count for e in hits)
        if 2 * n >= reps:
            return sum(e.self_device_time_total for e in hits) / n / 1e3
    raise RuntimeError(f"the profiler saw {n} launches of {symbol} in "
                       f"{reps} calls")


def knn_against_plain(args, got, ref, limit) -> float:
    """Hold K3's `knn2` output `got` to the plain version's `ref` on the
    same inputs `args`, rank by rank (both recompute their winners'
    distances alike): the same slots filled; each rank's distance within
    the plain version's rounding (its expansion |q|^2 + |c|^2 - 2 q.c in
    float32, KNN_EXPANSION_ROUNDING of the largest |q|^2 + |c|^2, plus
    KNN_REL of the distance); and the same index at every rank whose
    distance lies further than that from both neighbours in K3's list.
    The last rank's neighbour beyond the list is unseen, so the last rank
    is held by its distance alone. Returns the share of rows whose ordered
    indices differ anywhere (near-ties), and raises where it reaches
    `limit` (None: no limit)."""
    import torch
    from dqo_map_tpu_torch.ops.knn import BIG
    q, c = args[0], args[1]
    atol = KNN_EXPANSION_ROUNDING * float((q * q).sum(1).max()
                                          + (c * c).sum(1).max())
    differ = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for s, ((gd, gi), (rd, ri)) in enumerate(zip(got, ref)):
        filled = gd < 0.5 * BIG
        tol = KNN_REL * rd + atol
        edge = torch.full_like(gd[:, :1], -torch.inf)
        gap_lo = gd - torch.cat([edge, gd[:, :-1]], 1)
        gap_hi = torch.cat([gd[:, 1:], edge], 1) - gd
        clear = filled & (gap_lo > tol) & (gap_hi > tol)
        bad = ((filled != (rd < 0.5 * BIG)).any(1)
               | (filled & ((gd - rd).abs() > tol)).any(1)
               | (clear & (gi != ri)).any(1))
        if bad.any():
            r = int(bad.nonzero()[0])
            raise RuntimeError(
                f"K3, list {'ab'[s]}: {int(bad.sum())} rows disagree with "
                f"the plain version beyond its rounding; row {r}: "
                f"{gd[r].tolist()} {gi[r].tolist()} against "
                f"{rd[r].tolist()} {ri[r].tolist()}")
        differ |= (filled & (gi != ri)).any(1)
    share = float(differ.float().mean())
    if limit is not None and share >= limit:
        raise RuntimeError(f"K3: the ordered indices of {share:.4%} of rows "
                           f"differ from the plain version's")
    return share


def knn_against_f64(args, got, rows: int = 512) -> float:
    """Hold K3's `knn2` output `got` to a float64 brute force on the card
    by direct differences, rank by rank: the same slots filled, each
    rank's distance (recomputed in float64) within KNN_REL of the brute
    force's at that rank, and the same index wherever the brute force's
    gap to both neighbouring ranks (rank k + 1 included) exceeds that.
    Returns the share of rows whose ordered indices differ anywhere
    (float32 ties)."""
    import torch
    from dqo_map_tpu_torch.ops.knn import BIG
    q, c, masks = args[0].double(), args[1].double(), args[2:4]
    M, N, k = q.shape[0], c.shape[0], got[0][1].shape[1]
    differ = torch.zeros(M, dtype=torch.bool, device=q.device)
    for s, ((d, i), mask) in enumerate(zip(got, masks)):
        for r0 in range(0, M, rows):
            r1 = min(M, r0 + rows)
            dd = ((q[r0:r1, None, :] - c[None]) ** 2).sum(-1)
            dd = torch.where(mask[None], dd, torch.inf)
            kk = min(k + 1, N)
            ref_d, ref_i = torch.topk(dd, kk, dim=1, largest=False)
            pad = torch.full((r1 - r0, k + 1 - kk), torch.inf,
                             dtype=ref_d.dtype, device=q.device)
            ref_d, ref_i = torch.cat([ref_d, pad], 1), torch.cat(
                [ref_i, pad.long()], 1)
            gd, gi = d[r0:r1], i[r0:r1]
            filled = torch.isfinite(ref_d[:, :k])
            dist = ((q[r0:r1, None, :] - c[gi]) ** 2).sum(-1)
            tol = KNN_REL * ref_d[:, :k]
            lo = torch.cat([torch.full_like(ref_d[:, :1], -torch.inf),
                            ref_d[:, :k - 1]], 1)
            clear = (filled & (ref_d[:, :k] - lo > tol)
                     & (ref_d[:, 1:] - ref_d[:, :k] > tol))
            bad = (((gd < 0.5 * BIG) != filled).any(1)
                   | (filled & ((dist - ref_d[:, :k]).abs() > tol)).any(1)
                   | (clear & (gi != ref_i[:, :k])).any(1))
            if bad.any():
                r = int(bad.nonzero()[0])
                raise RuntimeError(
                    f"K3, list {'ab'[s]}: {int(bad.sum())} rows of "
                    f"{r0}-{r1} disagree with the float64 brute force; row "
                    f"{r0 + r}: {gd[r].tolist()} {gi[r].tolist()} against "
                    f"{ref_d[r].tolist()} {ref_i[r].tolist()}")
            differ[r0:r1] |= (filled & (gi != ref_i[:, :k])).any(1)
    return float(differ.float().mean())


def k3_ms(args) -> tuple:
    """K3's ms a call on `args` by CUDA events around each of KNN_REPS
    calls after a warm-up, with the L2 flushed before each, as
    densification finds it: (median, least, most)."""
    import torch
    from dqo_map_tpu_torch.ops import knn
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=args[0].device)
    knn.knn2_cuda(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(KNN_REPS)]
    for start, stop in events:
        flush.zero_()
        start.record()
        knn.knn2_cuda(*args)
        stop.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2], times[0], times[-1]


def knn_phase(device) -> dict:
    """K3 at explore's densify shapes on densify's layout (the new points
    first, outside mask_a; ~half the map unstable, ~90% of slots not
    dead; points uniform in a 4 m room): held rank by rank to a float64
    brute force (`knn_against_f64`) and to its plain version
    (`knn_against_plain`, near-ties on under 1% of rows), then
    its ms a call (`k3_ms`), the search kernel's own device time (the
    profiler's), the plain version's ms and the bound: the pairs the masks
    admit times KNN_OPS float operations at the FP32 peak."""
    import torch
    from dqo_map_tpu_torch.ops import knn
    rng = np.random.default_rng(18)
    c = torch.as_tensor(rng.uniform(-2.0, 2.0, (KNN_N, 3)).astype(np.float32),
                        device=device)
    ma = np.zeros(KNN_N, bool)
    ma[KNN_M:] = rng.uniform(size=KNN_N - KNN_M) < 0.5
    ma = torch.as_tensor(ma, device=device)
    mb = torch.as_tensor(rng.uniform(size=KNN_N) < 0.9, device=device)
    q = c[:KNN_M].clone()
    args = (q, c, ma, mb, KNN_K)
    launches = dict(knn.LAUNCHES)
    got = knn.knn2(*args)
    if knn.LAUNCHES != {k: v + 1 for k, v in launches.items()}:
        raise RuntimeError(f"K3 launches {launches} -> {knn.LAUNCHES}, "
                           "wanted the pack and the search once")
    ties = knn_against_f64(args, got)
    share = knn_against_plain(args, got, knn.knn2_ref(*args), 0.01)
    ms, lo, hi = k3_ms(args)
    dev_ms = device_ms(lambda: knn.knn2_cuda(*args), "knn2_kernel", 5)
    plain_ms = time_cuda(lambda: knn.knn2_ref(*args), 3)
    pairs = KNN_M * int((ma | mb).sum())
    bound_ms = pairs * KNN_OPS / PEAK_F32_PER_S * 1e3
    print(f"knn (K3): {ms:.3f} ms a call (median of {KNN_REPS}, "
          f"{lo:.3f}-{hi:.3f}, L2 flushed), search kernel {dev_ms:.3f} ms "
          f"device time; plain version (chunked torch.topk) {plain_ms:.1f} "
          f"ms; bound {bound_ms:.3f} ms ({pairs} pairs x {KNN_OPS} ops); M "
          f"{KNN_M}, N {KNN_N}, k {KNN_K}; ordered indices differ from the "
          f"plain version's at near-ties on {share:.4%} of rows, from a "
          f"float64 brute force's at float32 ties on {ties:.4%}; "
          f"{card_line()}")
    return {"name": "knn", "route": "cuda",
            "source": "dqo_map_tpu_torch/csrc/knn.cu", "replaces": None,
            "rows_differing": share, "rows_tied_f64": ties, "ms": ms,
            "ms_range": [lo, hi], "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": plain_ms}


def knn_path_a(k3) -> dict:
    """K3 on the main path: its launches over the densified frames (each
    already held to one pack and one search), and the last frame's search
    again on its own inputs, held rank by rank to a float64 brute force
    and to the plain version, and timed as in `knn_phase`."""
    from dqo_map_tpu_torch.ops import knn
    tensors, rest, kw = k3["inputs"]
    args = (*tensors, *rest)
    got = knn.knn2(*args, **kw)
    ties = knn_against_f64(args, got)
    share = knn_against_plain(args, got, knn.knn2_ref(*args, **kw), None)
    k = int(got[0][1].shape[1])
    ms, lo, hi = k3_ms((*tensors, k))
    M, N = tensors[0].shape[0], tensors[1].shape[0]
    launches = sum(c["knn"] for c in k3["calls"])
    print(f"knn (K3) on the main path: {launches} launches over "
          f"{len(k3['calls'])} densified frames; the last frame's search "
          f"(M {M}, N {N}, k {k}) {ms:.3f} ms a call ({lo:.3f}-{hi:.3f}, "
          f"L2 flushed); ordered indices differ from the plain version's "
          f"at near-ties on {share:.4%} of rows, from a float64 brute "
          f"force's at float32 ties on {ties:.4%}")
    return {"launches": launches, "main_path": {
        "M": M, "N": N, "k": k, "ms": ms, "ms_range": [lo, hi],
        "rows_differing": share, "rows_tied_f64": ties}}


def project_phase(state, cin, settings) -> dict:
    """K4 on `state`'s render at camera `cin` with `settings`, as the model
    render and the scans call it (the leaves as stored, SH colours, the
    subset's mask): the forward's geometry `torch.equal` to the plain
    chain's (torch's activations, `preprocess_ref`), its colours and the
    pack against the plain pack; the backward of a K2-shaped cotangent
    (rows 13 and 14 and padding 0) against `project_bwd_ref` (1e-5 of each
    leaf's largest gradient: the same operations, rounded alike but for
    the sums' order) and the plain chain's autograd in float64 (each
    leaf's relative L2 error at most twice the float32 plain chain's,
    plus 1e-6: flat Gaussians make the covariance's gradient
    ill-conditioned in float32 either way); then each kernel's device time a
    launch (the profiler's), the bytes' bound (each input byte read once,
    each output byte written once, at 3.35 TB/s) and the plain chain's
    time, forward and forward with backward."""
    import torch
    from dqo_map_tpu_torch.ops import project_cuda
    from dqo_map_tpu_torch.ops.blend import gather_entry_feats
    from dqo_map_tpu_torch.ops.projection import (preprocess_ref,
                                                  project_bwd_ref)
    from dqo_map_tpu_torch.ops.rasterize import _activated
    from dqo_map_tpu_torch.slam.renderer import (compute_binning_state,
                                                 state_render_args)
    args = state_render_args(state, cin, settings)
    keys = ("means3d", "scales", "rots", "opacities", "colors")
    lv = [args[k].detach().contiguous() for k in keys]
    mask = args["valid_mask"]
    b = compute_binning_state(state, cin, settings)
    spec = project_cuda.make_spec(cin, settings, lv[4], True)
    P, L = lv[0].shape[0], b.demand

    def plain(leaves):
        sc, ro, op, col = _activated(leaves[0], leaves[1], leaves[2],
                                     leaves[3], leaves[4], cin, settings,
                                     True)
        pre = preprocess_ref(leaves[0], sc, ro, cin, settings.color_sigma,
                             settings.width, settings.height,
                             settings.scale_modifier)
        pre = pre._replace(valid=pre.valid & mask,
                           radius=torch.where(mask, pre.radius, 0.0))
        return pre, gather_entry_feats(
            b.point_list, b.entry_valid, pre.xy, pre.conic, op, col,
            pre.depth, pre.mean_c, pre.normal_c, pre.scale_max)

    with torch.no_grad():
        table, valid = project_cuda.project_fwd(*lv, cin, spec, mask)
        feats = project_cuda.project_pack(table, b.point_list, b.entry_valid)
        want_pre, want_feats = plain(lv)
    got_pre = project_cuda.preprocessed(table, valid)
    for k, v in want_pre._asdict().items():
        if not torch.equal(getattr(got_pre, k), v):
            raise RuntimeError(f"K4's {k} differs from the plain preprocess")
    geo = [r for r in range(16) if r not in (6, 7, 8)]
    if not torch.equal(feats[geo], want_feats[geo]):
        raise RuntimeError("K4's pack differs from the plain pack")
    color_err = float((feats[6:9] - want_feats[6:9]).abs().max())
    if color_err > 2e-6:
        raise RuntimeError(f"K4's colours {color_err} off the plain ones")

    g = torch.Generator(device=lv[0].device).manual_seed(22)
    d = torch.randn(16, L, generator=g, device=lv[0].device)
    d[13] = d[14] = 0.0
    d = torch.where(b.entry_valid[None, :], d, 0.0)
    got = project_cuda.project_bwd(d, b.cell_entry, *lv, cin, spec)
    ref = project_bwd_ref(d, b.cell_entry, *lv, cin, settings.width,
                          settings.height, settings.scale_modifier, True,
                          settings.sh_degree)
    errs = {}
    for k, a, c in zip(keys, got, ref):
        e = float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
        errs[f"ref_{k}"] = e
        if e > 1e-5:
            raise RuntimeError(f"K4's backward: {k} {e:.3g} of its largest "
                               "gradient off project_bwd_ref (1e-5)")

    def autograd(dtype):
        ls = [x.to(dtype).requires_grad_(True) for x in lv]
        c = {k: v.to(dtype) if torch.is_tensor(v) else v
             for k, v in cin.items()}
        sc, ro, op, col = _activated(ls[0], ls[1], ls[2], ls[3], ls[4], c,
                                     settings, True)
        pre = preprocess_ref(ls[0], sc, ro, c, settings.color_sigma,
                             settings.width, settings.height,
                             settings.scale_modifier)
        f = gather_entry_feats(b.point_list, b.entry_valid, pre.xy,
                               pre.conic, op, col, pre.depth, pre.mean_c,
                               pre.normal_c, pre.scale_max)
        return torch.autograd.grad(torch.sum(f * d.to(dtype)), ls)

    # against float64: no further than twice the float32 plain chain
    truth, auto32 = autograd(torch.float64), autograd(torch.float32)
    for k, a, a32, t in zip(keys, got, auto32, truth):
        n = max(float(t.norm()), 1e-300)
        e, e32 = (float((x.double() - t).norm()) / n for x in (a, a32))
        errs[f"f64_{k}"], errs[f"f64_plain_{k}"] = e, e32
        if e > 2.0 * e32 + 1e-6:
            raise RuntimeError(f"K4's backward: {k} {e:.3g} off float64, "
                               f"the plain chain {e32:.3g}")

    live = int(b.num_entries)
    R = b.cell_entry.shape[0]
    in_b = 4 * (3 + 3 + 4 + 1 + 48) + 1          # leaves and mask a row
    n_bytes = {"project_fwd": P * (in_b + 4 * 22 + 1),
               "project_pack": P * 64 + L * (8 + 1 + 64),
               "project_bwd": (P * (in_b - 1 + 4 * R) + live * 14 * 4
                               + P * 4 * (3 + 3 + 4 + 1 + 48))}
    calls = {
        "project_fwd": lambda: project_cuda.project_fwd(*lv, cin, spec,
                                                        mask),
        "project_pack": lambda: project_cuda.project_pack(
            table, b.point_list, b.entry_valid),
        "project_bwd": lambda: project_cuda.project_bwd(
            d, b.cell_entry, *lv, cin, spec)}
    ms = {k: device_ms(fn, f"{k}_kernel", 20) for k, fn in calls.items()}
    bound = {k: n / PEAK_BYTES_PER_S * 1e3 for k, n in n_bytes.items()}

    def plain_step(backward):
        ls = [x.clone().requires_grad_(backward) for x in lv]
        _, f = plain(ls)
        if backward:
            torch.autograd.grad(torch.sum(f * d), ls)

    with torch.no_grad():
        plain_fwd_ms = time_cuda(lambda: plain(lv), 10)
    plain_step_ms = time_cuda(lambda: plain_step(True), 10)

    def k4_step():
        ls = [x.clone().requires_grad_(True) for x in lv]
        _, _, f = project_cuda.blend_inputs(*ls, cin, settings, mask, True,
                                            lambda pre: b)
        torch.autograd.grad(torch.sum(f * d), ls)

    k4_step_ms = time_cuda(k4_step, 10)
    for k in calls:
        print(f"{k} (K4): {ms[k]:.4f} ms a launch, bound {bound[k]:.4f} ms "
              f"({n_bytes[k]} bytes)")
    print(f"K4 at P {P}, L {L} ({live} live entries): forward and backward "
          f"through the wrapper {k4_step_ms:.3f} ms, the plain chain "
          f"{plain_step_ms:.3f} ms (forward alone {plain_fwd_ms:.3f}); "
          f"colours {color_err:.3g} off, backward {errs}; {card_line()}")
    return {"name": "project", "route": "cuda",
            "source": "dqo_map_tpu_torch/csrc/project.cu", "replaces": None,
            "P": P, "L": L, "live_entries": live, "ms": ms,
            "bound_ms": bound, "bound_by": "bytes",
            "step_ms": k4_step_ms, "plain_step_ms": plain_step_ms,
            "plain_fwd_ms": plain_fwd_ms, "color_err": color_err,
            "grad_err": errs, "library_ms": None}


def tile_entries(tile_counts, align: int, max_chunks: int) -> dict:
    """Live entries per non-empty tile (mean, p99, max), the align-sized
    blocks they fill, and the tiles at the per-tile cap."""
    import torch
    c = tile_counts[tile_counts > 0].double()
    return {"tiles": int(c.numel()), "mean": float(c.mean()),
            "p99": float(torch.quantile(c, 0.99)), "max": int(c.max()),
            "align": align,
            "blocks": int(((tile_counts + align - 1) // align).sum()),
            "at_cap": int((tile_counts == align * max_chunks).sum())}


def kernel_row(name, launches, max_err, times, n_bytes, pairs, ops, tiles):
    ms, wrapper_ms, plain_ms = times
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = pairs * ops / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"{name}: {ms:.4f} ms device time per launch ({wrapper_ms:.4f} ms "
          f"through the wrapper), plain version {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms; {pairs} pixel-entry pairs x {ops} ops -> "
          f"{ops_ms:.4f} ms); launches {launches}, max |diff| {max_err:.3g}")
    print(f"{name}: live entries per non-empty tile {tiles}")
    return {
        "name": name, "route": "cuda",
        "source": "dqo_map_tpu_torch/csrc/"
                  + ("blend_fwd.cu" if "fwd" in name else "blend_bwd.cu"),
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": max_err, "ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "tile_entries": tiles,
    }


def order_times(name, fn, args, kw) -> dict:
    """The launch order's worth, and the floor the most crowded tile sets:
    the device time of `fn` (a kernel's wrapper, whose kernel's name holds
    `fn.__name__`) with the tiles in tile order, and with the first tile of
    the order alone (the others' counts 0, so their CTAs walk nothing)."""
    import torch
    if kw.get("tile_order") is None:
        raise RuntimeError(f"{name}: the main path launched it without the "
                           "binning's tile_order")
    counts, first = args[2], kw["tile_order"][0]
    tiles = torch.arange(len(counts), device=counts.device)
    crowded = args[:2] + (torch.where(tiles == first, counts, 0),) + args[3:]
    sym = fn.__name__
    out = {"layout_order_ms": device_ms(
               lambda: fn(*args, **dict(kw, tile_order=None)), sym, 20),
           "crowded_tile_ms": device_ms(lambda: fn(*crowded, **kw), sym, 20)}
    print(f"{name}: {out['layout_order_ms']:.4f} ms with the tiles in tile "
          f"order; the most crowded tile alone {out['crowded_tile_ms']:.4f} "
          "ms")
    return out


def check_fwd(name, args, kw, launches, layout) -> dict:
    """K1 (plain or background variant) against its plain version on
    recorded inputs: the index channels and n_touched exactly, the depth
    channels to 1e-4, the other floats to 1e-5."""
    import torch
    from dqo_map_tpu_torch.ops.blend import blend_blocks_ref
    from dqo_map_tpu_torch.ops.blend_cuda import blend_fwd
    bgt = kw.get("bgt")
    order_ms = order_times(name, blend_fwd, args, kw)
    color, aux, nt = blend_fwd(*args, **kw)
    stats = {}
    rcolor, raux, rnt = blend_blocks_ref(*args, bgt=bgt, stats=stats)
    torch.cuda.synchronize()
    for what, a, r in (("index maps", aux[..., 0:2], raux[..., 0:2]),
                       ("n_touched", nt, rnt)):
        n_bad = int((a != r).sum())
        if n_bad:
            raise RuntimeError(f"{name}: {what} differ at {n_bad} places")
    max_err = 0.0
    for what, a, r, tol in (
            ("colour and normal", color[..., [0, 1, 2, 4, 5, 6]],
             rcolor[..., [0, 1, 2, 4, 5, 6]], 1e-5),
            ("weights and T", aux[..., 2:7], raux[..., 2:7], 1e-5),
            ("depth", torch.stack([color[..., 3], aux[..., 7]]),
             torch.stack([rcolor[..., 3], raux[..., 7]]), 1e-4)):
        err = float((a - r).abs().max())
        if not err <= tol:
            raise RuntimeError(f"{name}: {what} off by {err} > {tol}")
        max_err = max(max_err, err)
    times = (device_ms(lambda: blend_fwd(*args, **kw), "blend_fwd", 20),
             time_cuda(lambda: blend_fwd(*args, **kw), reps=20),
             time_cuda(lambda: blend_blocks_ref(*args, bgt=bgt), reps=2))
    T, n_live = args[3], int(args[2].sum())
    # live entries' 16 feature rows in and n_touched out (the padding is
    # never read), each tile's offset and count, the two (T, 256, 8) output
    # blocks, and the background operand's five channels
    n_bytes = (n_live * (16 * 4 + 4) + T * 16 + 2 * T * 256 * 8 * 4
               + (T * 256 * 5 * 4 if bgt is not None else 0))
    print(f"{name} vs plain version on {T} tiles, {n_live} live entries: "
          "index maps and n_touched equal")
    return dict(kernel_row(name, launches, max_err, times, n_bytes,
                           stats["pairs"],
                           OPS_FWD_BG if bgt is not None else OPS_FWD,
                           tile_entries(args[2], *layout)), **order_ms)


def check_bwd(name, args, kw, launches, layout) -> dict:
    """K2 (plain or background variant) against its plain version on
    recorded inputs: each gradient row to 1e-4 of its largest magnitude."""
    import torch
    from dqo_map_tpu_torch.ops.blend import GRAD_ROWS, blend_bwd_ref
    from dqo_map_tpu_torch.ops.blend_cuda import blend_bwd
    bgt = kw.get("bgt")
    order_ms = order_times(name, blend_bwd, args, kw)
    got = blend_bwd(*args, **kw)
    stats = {}
    ref = blend_bwd_ref(*args, bgt=bgt, stats=stats)
    torch.cuda.synchronize()
    # an entry's depth cotangents are +-c of one magnitude c, and their sum
    # can cancel to exactly 0 in one order and to a rounding residue in the
    # other: such places are bounded in number and in size
    flip = (got != 0) != (ref != 0)
    n_flip = int(flip.sum())
    if n_flip > MAX_FLIPS:
        raise RuntimeError(f"{name}: zero structure differs at {n_flip} "
                           f"places (at most {MAX_FLIPS} allowed)")
    max_err, max_flip_rel = 0.0, 0.0
    for r in GRAD_ROWS:
        diff = (got[r] - ref[r]).abs()
        err = float(diff.max())
        scale = float(ref[r].abs().max())
        if not err <= 1e-4 * scale:
            raise RuntimeError(f"{name}: gradient row {r} off by {err} "
                               f"(row max {scale})")
        if bool(flip[r].any()):
            flip_err = float(diff[flip[r]].max())
            if not flip_err <= FLIP_TOL * scale:
                raise RuntimeError(
                    f"{name}: gradient row {r} is 0 on one side only, off "
                    f"by {flip_err} > {FLIP_TOL} x row max {scale}")
            max_flip_rel = max(max_flip_rel, flip_err / scale)
        max_err = max(max_err, err)
    times = (device_ms(lambda: blend_bwd(*args, **kw), "blend_bwd", 20),
             time_cuda(lambda: blend_bwd(*args, **kw), reps=20),
             time_cuda(lambda: blend_bwd_ref(*args, bgt=bgt), reps=2))
    T, n_live = args[3], int(args[2].sum())
    T_live = int((args[2] > 0).sum())
    # per live entry: 16 feature rows in, 14 gradient rows out; per pixel
    # of a tile with entries (no other pixel reaches a gradient) the
    # cotangent's 7 channels, 3 of the colour block, 2 of the aux block
    # (and 5 of the background operand); each tile's offset and count
    n_bytes = (n_live * (16 + 14) * 4 + T * 16 + T_live * 256 * 12 * 4
               + (T_live * 256 * 5 * 4 if bgt is not None else 0))
    print(f"{name} vs plain version on {T} tiles, {n_live} live entries: "
          f"rows to 1e-4 of their max; zero structure equal but at {n_flip} "
          f"places, largest there {max_flip_rel:.3g} of its row's max")
    return dict(kernel_row(name, launches, max_err, times, n_bytes,
                           stats["pairs"], OPS_BWD,
                           tile_entries(args[2], *layout)), **order_ms)


def report_times(system, infos, final: dict, tail: dict, seconds: float,
                 window: dict, passes, card: str):
    """Per-frame times (optimize frames apart, after warm-up), the timed
    window's wall time, and where the whole run's time went. Under loose
    sync a frame's times are the host's (the time to queue its work and to
    wait for what it reads back) but on the frames that end in a sync."""
    for i, info in enumerate(infos):
        synced = system._frame_syncs(i)
        print(f"frame {i:3d}: tracking {1e3 * info['tracker_s']:8.1f} ms  "
              f"mapping {1e3 * info['mapper_s']:8.1f} ms  "
              f"({'device, synced' if synced else 'host'})  pose "
              f"{info['source']}  entries {info['render']['num_entries']}"
              + ("  (optimize)" if info["optimized"] else ""))
    n_win = len(infos) - WARMUP_FRAMES
    win = window["t1"] - window["t0"]
    print(f"timed window, frames {WARMUP_FRAMES}-{len(infos) - 1} "
          f"({system.sync_method} sync every {system.sync_frames} frames), "
          f"synchronised at both ends: {1e3 * win:.1f} ms wall, "
          f"{1e3 * win / n_win:.1f} ms a frame; the frames' own host times "
          f"sum to {1e3 * sum(i['tracker_s'] + i['mapper_s'] for i in infos[WARMUP_FRAMES:]):.1f} ms"
          f" [{card}]")
    for label, sel in (("optimize frames", True), ("other frames", False)):
        part = [i for i in infos[WARMUP_FRAMES:] if i["optimized"] == sel] \
            or [i for i in infos if i["optimized"] == sel]
        if part:
            tr = 1e3 * sum(i["tracker_s"] for i in part) / len(part)
            mp = 1e3 * sum(i["mapper_s"] for i in part) / len(part)
            print(f"per frame (host clock), {label} ({len(part)}): tracking "
                  f"{tr:.1f} ms, mapping {mp:.1f} ms, total {tr + mp:.1f} ms")
    frames_s = sum(i["tracker_s"] + i["mapper_s"] for i in infos)
    parts = {"frames": frames_s, "final pass": final["seconds"],
             f"evaluations ({len(tail['_eval'])})": sum(tail["_eval"]),
             "trajectory": sum(tail["save_traj"]),
             "PLY export": sum(tail["save_model"]),
             "colour passes": passes.seconds,
             "the final pass's objective sums and masks (this script's)":
                 final["uncounted_s"]}
    print(f"whole run {seconds:.2f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in parts.items())
        + f", the rest {seconds - sum(parts.values()):.3f} s; evaluations "
        + " / ".join(f"{x:.3f}" for x in tail["_eval"]) + " s")


def report_tracking_objects(system, infos, host: dict, result: dict,
                            card: str):
    """The feature backend's host time a frame in `detect` and `track`, the
    pose sources, keyframes and loop closures; the objects, their capacity
    receipts, mean projected-box IoU and the time of each refinement."""
    import numpy as np
    be = system.tracker.pose_backend
    for name in ("detect", "track"):
        t = host.get(name, [])
        print(f"feature backend {name}: {len(t)} calls, host "
              f"{1e3 * float(np.mean(t)):.1f} ms a call (min "
              f"{1e3 * min(t):.1f}, max {1e3 * max(t):.1f}) [{card}]")
    sources = [i["source"] for i in infos[1:]]
    counts = {k: sources.count(k) for k in POSE_SOURCES}
    print(f"pose sources over frames 1-{len(infos) - 1}: {counts}; backend "
          f"keyframes {be.num_keyframes()}, loop closures {be.loop_closures}, "
          f"landmarks {be.num_mappoints()} [{card}]")
    if sum(counts.values()) != len(sources) or infos[0]["source"] != "init":
        raise RuntimeError(f"pose sources {[i['source'] for i in infos]}")
    layer = system.object_layer
    ious = list(layer.iou_log.values())
    opt = host.get("optimize_objects", [])
    print(f"objects: n_objects {result['n_objects']}, obj_obs_trimmed "
          f"{result['obj_obs_trimmed']}, obj_over_cap {result['obj_over_cap']}"
          f", mean record_iou {float(np.mean(ious)) if ious else 0.0:.4f} "
          f"over {len(ious)}; optimize_objects {len(opt)} calls, "
          + " / ".join(f"{1e3 * t:.1f}" for t in opt) + f" ms [{card}]")
    if not (result["n_objects"] >= 1 and opt and ious):
        raise RuntimeError(f"the object layer made {result['n_objects']} "
                           f"objects and {len(opt)} refinements")
    print(f"ATE at frame {len(infos) - 1}: {result['ate_cm']:.4f} cm [{card}]")


def report_final(system, final: dict, result: dict):
    """The final pass's counts, times, objective and the quality before
    and after it (the evaluations at the last frame before the pass and
    after it)."""
    m = system.mapping
    sc, kf = final["scans"], final["keyframes"]
    want = kf * int(system.cfg.map.final_global_iter)
    print(f"final pass: {kf} keyframes {m.keyframe_ids}, {sc['iters']} "
          f"iterations ({want} wanted), {sc['range_renders']} range renders; "
          f"{final['seconds']:.2f} s, "
          f"{1e3 * final['seconds'] / max(sc['iters'], 1):.1f} ms an "
          f"iteration; launches {final['launches']}; the objective's and "
          f"masks' own {final['uncounted_launches']} launches not counted")
    if sc["final"] != 1 or sc["iters"] != want:
        raise RuntimeError(f"the final pass ran {sc}, wanted one pass of "
                           f"{want} iterations")
    # with semantics, each iteration also blends the semantic pass; data-
    # parallel, each iteration blends every keyframe
    blends = sc["blends"]
    if final["launches"]["blend_fwd"] != blends + sc["range_renders"] \
            or final["launches"]["blend_bwd"] != blends:
        raise RuntimeError(f"final pass launches {final['launches']} for "
                           f"{sc['iters']} iterations ({sc['sem_iters']} "
                           f"with the semantic pass, {blends} blends)")
    before, after = final["objective"]
    print(f"final pass objective over every keyframe: {before:.6f} -> "
          f"{after:.6f}")
    if not after < before:
        raise RuntimeError(f"the final pass did not optimise: {before} -> "
                           f"{after}")
    pre = [h for h in system.metrics_history if h["frame"] != "final"][-1]
    q0 = (pre["psnr"], pre["depth_l1_cm"], final["ate_before_cm"])
    q1 = (result["psnr"], result["depth_l1_cm"], result["ate_cm"])
    for label, (p, d, a) in ((f"before the final pass (frame {pre['frame']})",
                              q0), ("after it (final)", q1)):
        print(f"evaluation {label}: PSNR {p:.2f} dB, depth-L1 {d:.3f} cm, "
              f"ATE {a:.4f} cm")
    if not all(math.isfinite(x) for x in q0 + q1) or min(q0[0], q1[0]) <= 15:
        raise RuntimeError(f"evaluation off: before {q0}, after {q1}")
    print(f"final evaluation: SSIM {result['ssim']:.4f}, MS-SSIM "
          f"{result['ms_ssim']:.4f}, colour-L1 {result['color_l1']:.4f}, "
          f"valid ratio {result['valid_ratio']:.4f}; fps {result['fps']:.3f}, "
          f"peak device memory {result['max_mem_GB']:.2f} GiB")


def check_outputs(system) -> str:
    """The files `run()` writes; returns the merged PLY's path."""
    import glob
    from dqo_map_tpu_torch.models import gaussian_map as gm
    m = system.mapping
    base = os.path.join(RUN_DIR, "save_model", f"frame_{m.time:04d}",
                        f"iter_{m.iter:04d}")
    want = [os.path.join(RUN_DIR, "save_traj", f) for f in (
        "pose_es.npy", "pose_gt.npy", "poses.txt", "ate.txt")]
    want += [base + "_stable.ply", base + "_merge.ply",
             os.path.join(RUN_DIR, "performance.json"),
             os.path.join(RUN_DIR, "save_obj", "objects.txt"),
             os.path.join(RUN_DIR, "save_obj", "iou.txt")]
    want += [os.path.join(RUN_DIR, "eval_render", k) for k in (
        "color_compare.jpg", "depth_compare.jpg", "instance.png",
        "semantic.png")]
    missing = [f for f in want if not os.path.isfile(f)]
    if not missing:
        with open(os.path.join(RUN_DIR, "save_obj", "objects.txt")) as f:
            n_lines = len(f.read().splitlines())
        if n_lines != len(system.object_layer.objects):
            missing.append(f"objects.txt with {len(system.object_layer.objects)}"
                           f" lines (has {n_lines})")
    # the unstable PLY is written only for a non-empty subset, and the
    # final pass promotes every unstable Gaussian
    has_unstable = int((m.state.status == gm.UNSTABLE).sum()) > 0
    if os.path.isfile(base + ".ply") != has_unstable:
        missing.append(base + ".ply" + (" (unexpected)" if not has_unstable
                                        else ""))
    if missing:
        raise RuntimeError(f"run() did not write {missing}")
    files = sorted(glob.glob(os.path.join(RUN_DIR, "**", "*"), recursive=True))
    print(f"run outputs ({'with' if has_unstable else 'no'} unstable PLY): "
          + ", ".join(os.path.relpath(f, RUN_DIR) for f in files
                      if os.path.isfile(f)))
    return base + "_merge.ply"


def _render(state, cin, settings):
    import torch
    from dqo_map_tpu_torch.slam.renderer import render_state
    with torch.no_grad():
        return render_state(state, cin, settings, "global")


def ply_round_trip(system, state, cin, merge_ply: str):
    """The saved merged PLY, reloaded and rendered at the last camera,
    against the render of the saved `state`: colour to 1e-5, depth to
    1e-4."""
    from dqo_map_tpu_torch.utils.ply import load_map_ply
    m = system.mapping
    loaded = load_map_ply(merge_ply, state.capacity, device=m.device)
    a, b = _render(state, cin, m.settings), _render(loaded, cin, m.settings)
    errs = {k: float((a[k] - b[k]).abs().max()) for k in ("render", "depth")}
    print(f"PLY round trip: {loaded.count} Gaussians reloaded; render at the "
          f"last camera off by {errs['render']:.3g} (colour), "
          f"{errs['depth']:.3g} (depth)")
    if not (errs["render"] <= 1e-5 and errs["depth"] <= 1e-4):
        raise RuntimeError(f"PLY round trip off: {errs}")


def same(a, b) -> bool:
    """Deep equality of nested dicts, lists and numpy arrays."""
    import numpy as np
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def checkpoint_round_trip(system, cams, cin, device):
    """`save_checkpoint`, then `resume` into a fresh system: map fields,
    keyframe ids, poses, time and the object layer equal, the render at the
    last camera bit-equal. The checkpoint (the memory frames' maps, some 100 MB a
    frame at this width) is deleted after."""
    import numpy as np
    import torch
    from dqo_map_tpu_torch.models.gaussian_map import FIELDS
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    path = os.path.join(RUN_DIR, "checkpoint", "ckpt")
    t0 = time.perf_counter()
    system.save_checkpoint(path)
    t1 = time.perf_counter()
    fresh = SLAMSystem(system.cfg, cameras=cams, device=device)
    nxt = fresh.resume(path)
    t2 = time.perf_counter()
    size = sum(os.path.getsize(path + ext) for ext in (".npz", ".pkl"))
    shutil.rmtree(os.path.dirname(path))
    a, b = system.mapping, fresh.mapping
    bad = [f for f in FIELDS
           if not torch.equal(getattr(a.state, f), getattr(b.state, f))]
    if a.state.count != b.state.count:
        bad.append("count")
    if a.keyframe_ids != b.keyframe_ids:
        bad.append("keyframe_ids")
    if nxt != a.time or b.time != a.time:
        bad.append("time")
    if not all(np.array_equal(p, q) for p, q in
               zip(system.tracker.poses_np(), fresh.tracker.poses_np())):
        bad.append("poses")
    if not same(system.object_layer.state_dict(),
                fresh.object_layer.state_dict()):
        bad.append("object layer")
    ra, rb = _render(a.state, cin, a.settings), _render(b.state, cin, b.settings)
    bad += [f"render {k}" for k in ("render", "depth", "depth_index_map",
                                    "T_map") if not torch.equal(ra[k], rb[k])]
    print(f"checkpoint round trip: {size / 1e6:.1f} MB written in "
          f"{t1 - t0:.1f} s, resumed in {t2 - t1:.1f} s at frame {nxt}; "
          + (f"map, keyframes, poses, time, the {len(fresh.object_layer.objects)}"
             " objects and render equal" if not bad
             else f"differ: {bad}"))
    if bad:
        raise RuntimeError(f"checkpoint round trip differs in {bad}")


def cli_phase(merge_ply: str, card: str, device):
    """The CLIs on the card: `run_slam` as a subprocess on 6 frames of
    `configs/synthetic/room.yaml` as it is (the reader's 160x120, the
    object layer on); `render_traj` as a subprocess on path A's merged PLY
    along its trajectory, every 4th pose, with the instance pass, one of
    its PNGs read back; the viewer on path A's run in a thread, on a free
    local port, its page, `/stats` and one `/render` with the overlays."""
    os.makedirs(CLI_DIR, exist_ok=True)
    out = os.path.join(CLI_DIR, "run")
    shutil.rmtree(out, ignore_errors=True)
    cfg = os.path.join(CLI_DIR, "config.yaml")
    with open(cfg, "w") as f:
        # the repo's synthetic room, cut to 6 frames
        f.write("parent: configs/synthetic/room.yaml\n"
                f"frame_num: 6\nsave_path: {out}\n")
    cmd = [sys.executable, "-m", "dqo_map_tpu_torch.cli.run_slam", "--config",
           cfg, "--max-frames", "6", "--quiet"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    if set(result) != RESULT_KEYS:
        raise RuntimeError(f"result.json keys {sorted(result)}, wanted "
                           f"{sorted(RESULT_KEYS)}")
    print(f"CLI: {' '.join(cmd)}: exit 0 in {seconds:.1f} s; result.json "
          f"PSNR {result['psnr']:.2f} dB, depth-L1 "
          f"{result['depth_l1_cm']:.3f} cm, ATE {result['ate_cm']:.4f} cm, "
          f"{result['n_objects']} objects")

    from dqo_map_tpu_torch.utils.jpeg import read_jpeg
    from dqo_map_tpu_torch.utils.png import read_png
    traj = os.path.join(RUN_DIR, "save_traj", "pose_es.npy")
    fly = os.path.join(CLI_DIR, "render_traj")
    shutil.rmtree(fly, ignore_errors=True)
    cmd = [sys.executable, "-m", "dqo_map_tpu_torch.cli.render_traj",
           "--config", cfg, "--model", merge_ply, "--traj", traj, "--out", fly,
           "--frame-step", "4", "--with-instance", "--device", str(device)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    n_poses = len(np.load(traj)[::4])
    pngs = sorted(os.listdir(fly))
    rgb = read_png(os.path.join(fly, "rgb_00000.png"))[0]
    print(f"CLI: render_traj on {os.path.basename(merge_ply)}: exit 0 in "
          f"{seconds:.1f} s, {len(pngs)} PNGs; rgb_00000.png {rgb.shape}, "
          f"mean {rgb.mean():.1f}")
    if len(pngs) != 3 * n_poses or rgb.ndim != 3 or not rgb.std() > 0:
        raise RuntimeError(f"render_traj wrote {pngs}, rgb {rgb.shape}")

    import urllib.request

    from dqo_map_tpu_torch.cli.viewer import load_view, make_server
    from dqo_map_tpu_torch.config import Config
    view = load_view(Config.from_yaml(cfg), RUN_DIR, 640, 480, 1 << 20,
                     str(device))
    srv = make_server(view, 0, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    # straight to the local server, never through a proxy
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    got = {}
    try:
        for route in ("/", "/stats", "/render?yaw=0.2&mode=color%2Bobj"):
            t0 = time.perf_counter()
            with opener.open(base + route, timeout=120) as r:
                got[route] = (r.headers["Content-Type"], r.read(),
                              time.perf_counter() - t0)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("the viewer's server thread did not stop")
    kind, body, render_s = got["/render?yaw=0.2&mode=color%2Bobj"]
    view_jpg = os.path.join(CLI_DIR, "viewer.jpg")
    with open(view_jpg, "wb") as f:
        f.write(body)
    img = read_jpeg(view_jpg)[0]
    stats = json.loads(got["/stats"][1])
    print(f"CLI: viewer on {RUN_DIR}: / {got['/'][0]}, /stats {stats}, "
          f"/render {kind} {img.shape} in {1e3 * render_s:.1f} ms, "
          f"{len(view.objects)} objects and {len(view.frusta)} frusta drawn "
          f"[{card}]")
    if not (got["/"][0] == "text/html" and kind == "image/jpeg"
            and img.shape == (480, 640, 3) and stats["n_gaussians"] > 0
            and view.objects):
        raise RuntimeError(f"viewer off: {kind} {img.shape}, {stats}")


# ---------------------------------------------------------------------------
# path B: semantic and instance supervision, objects in MODE=0, evaluation
# ---------------------------------------------------------------------------

def ray_labels(scene, c2w, K, width: int, height: int):
    """The synthetic room's ray cast (`SyntheticScene.render`), keeping
    what each ray hit: (label (H,W) int, the wall index 0-5 or 6 + the
    ellipsoid's, -1 for none; depth (H,W) float32, as `render` gives it)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs = (np.arange(width) - cx) / fx
    ys = (np.arange(height) - cy) / fy
    dirs_c = np.stack(np.broadcast_arrays(xs[None, :], ys[:, None], 1.0),
                      axis=-1).reshape(-1, 3)
    o = c2w[:3, 3]
    d = dirs_c @ c2w[:3, :3].T
    t_best = np.full(d.shape[0], np.inf)
    label = np.full(d.shape[0], -1)
    lo, hi = scene.bounds
    for axis in range(3):
        for side, bound in ((0, lo[axis]), (1, hi[axis])):
            denom = d[:, axis]
            safe = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            t = (bound - o[axis]) / safe
            p = o[None] + t[:, None] * d
            oa = [a for a in range(3) if a != axis]
            inside = (
                (t > 1e-4)
                & (p[:, oa[0]] >= lo[oa[0]] - 1e-6) & (p[:, oa[0]] <= hi[oa[0]] + 1e-6)
                & (p[:, oa[1]] >= lo[oa[1]] - 1e-6) & (p[:, oa[1]] <= hi[oa[1]] + 1e-6))
            hit = inside & (t < t_best)
            t_best = np.where(hit, t, t_best)
            label = np.where(hit, axis * 2 + side, label)
    for i, obj in enumerate(scene.objects):
        inv_a = 1.0 / obj["axes"]
        oc = (o - obj["center"]) * inv_a
        dc = d * inv_a[None, :]
        A = np.sum(dc * dc, axis=1)
        B = 2 * np.sum(oc[None, :] * dc, axis=1)
        C = np.sum(oc * oc) - 1.0
        disc = B * B - 4 * A * C
        t = (-B - np.sqrt(np.maximum(disc, 0))) / (2 * A)
        hit = (disc > 0) & (t > 1e-4) & (t < t_best)
        t_best = np.where(hit, t, t_best)
        label = np.where(hit, 6 + i, label)
    depth = np.where(np.isfinite(t_best), t_best, 0.0)
    return (label.reshape(height, width),
            depth.reshape(height, width).astype(np.float32))


def paint_semantics(scene, cams):
    """Each frame's semantic image, a class colour per wall and per
    ellipsoid (`CLASS_COLOURS`) found by the room's own ray cast, which
    must give the frame's depth bit for bit; the instance image is the
    same image, as the Replica reader makes it."""
    for cam in cams:
        label, depth = ray_labels(scene, cam.c2w, cam.K, cam.width,
                                  cam.height)
        if not np.array_equal(depth, cam.depth):
            raise RuntimeError(f"frame {cam.uid}: the semantic ray cast's "
                               "depth differs from the frame's")
        sem = np.where((label >= 0)[..., None],
                       CLASS_COLOURS[np.clip(label, 0, None)], 0.0)
        cam.semantics = cam.instance = sem.astype(np.float32)


def run_path_b(args, device, rec):
    """Path B, `SLAMSystem.run()` in `semantic_config` over the room's
    frames with their painted semantic and instance images. Its launches
    are counted from 0: K1 and K2 twice a scan iteration (the colour and
    the semantic pass), K1 once more for each memory frame's semantic
    background in a local scan, 20 of each for every frame whose MODE=0
    pass had objects, twice a final-pass iteration. The recorder keeps the
    semantic pass's background-variant launches (`_sem`) and MODE=0's
    (`_obj`), whose last are the last local scan's last iteration and the
    last frame's last object iteration. Returns (system, scene, info)."""
    import torch
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.models import gaussian_map as gm
    from dqo_map_tpu_torch.models.quadrics import OBJ_ITERS
    from dqo_map_tpu_torch.slam import mapper as mapper_mod
    from dqo_map_tpu_torch.slam.renderer import render_state
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    scene, cams = synthetic_sequence(args.frames, width=args.width,
                                     height=args.height, with_detections=True)
    paint_semantics(scene, cams)
    shutil.rmtree(RUN_B_DIR, ignore_errors=True)
    system = SLAMSystem(semantic_config(), cameras=cams, device=device)
    m, layer = system.mapping, system.object_layer
    inner_rs, inner_obj = mapper_mod.render_state, layer.optimize_objects_render
    obj = {"calls": 0, "with_objects": 0, "seconds": []}

    def tagged_render_state(*a, **kw):
        # the scans' semantic passes are their renders with colors_precomp
        if kw.get("colors_precomp") is None:
            return inner_rs(*a, **kw)
        rec.tag = "_sem"
        try:
            return inner_rs(*a, **kw)
        finally:
            rec.tag = None

    def optimize_objects_render(frame, settings):
        rec.tag = "_obj"
        t0 = time.perf_counter()
        try:
            n = inner_obj(frame, settings)
        finally:
            rec.tag = None
        torch.cuda.synchronize(device)
        obj["seconds"].append(time.perf_counter() - t0)
        obj["calls"] += 1
        obj["with_objects"] += n > 0
        return n

    # each scan's weighted instance curve, which no gradient reaches, and
    # the local scans' steps that replayed a graph (no host launch)
    inner_count, untrained, local_replayed = m._count_scan, [], [0]

    def count_scan(kind, reports):
        if reports["iters"]:
            untrained.append(float(m.opt.instance_weight)
                             * reports["instance_loss"])
        if kind == "local":
            local_replayed[0] += (reports.get("graph_replays", 0)
                                  - reports.get("graph_captures", 0))
        return inner_count(kind, reports)

    inner_step, infos = system.step, []

    def step(cam, i):
        info = inner_step(cam, i)
        info["optimized"] = m.did_optimize
        infos.append(info)
        return info

    mapper_mod.render_state = tagged_render_state
    layer.optimize_objects_render = optimize_objects_render
    m._count_scan = count_scan
    system.step = step
    final = FinalPass(system, rec, phase=None)
    m.global_optimization = final
    passes = ColorPasses(system, rec)
    system.save_object_passes = passes
    scans0 = dict(m.scan_counts)
    rec.phase, rec.tagged = None, {}
    reset_launches()
    t0 = time.perf_counter()
    try:
        with rec:
            result = system.run(eval_every=args.frames, verbose=False)
        torch.cuda.synchronize(device)
    finally:
        mapper_mod.render_state = inner_rs
        del layer.optimize_objects_render, m.global_optimization
        del system.save_object_passes, m._count_scan, system.step
        rec.phase = ""
    seconds = time.perf_counter() - t0
    launches = launches_now()
    obj_iters = OBJ_ITERS * obj["with_objects"]
    if passes.launches is None or passes.launches["blend_fwd"] != COLOR_PASSES:
        raise RuntimeError(f"path B's colour passes launched {passes.launches}")
    check_launches("path B", launches, scans0, m.scan_counts, m.renders,
                   COLOR_PASSES, obj_iters)
    sc = {k: m.scan_counts[k] - scans0[k] for k in m.scan_counts}
    if not (sc["sem_iters"] == sc["iters"] > 0
            and sc["sem_bg_renders"] == sc["bg_renders"] > 0):
        raise RuntimeError(f"path B ran the semantic pass in {sc['sem_iters']}"
                           f" of {sc['iters']} iterations and "
                           f"{sc['sem_bg_renders']} semantic backgrounds for "
                           f"{sc['bg_renders']}")
    # the host launches a local scan step's semantic pass unless the step
    # replayed its frame's graph
    local_iters = sum(len(c) for kind, c in m.scan_log
                      if kind == "local") - local_replayed[0]
    want = {"blend_fwd_sem": local_iters, "blend_bwd_sem": local_iters,
            "blend_fwd_obj": obj_iters, "blend_bwd_obj": obj_iters}
    got = {k: rec.tagged.get(k, 0) for k in want}
    print(f"path B: tagged launches {got}; MODE=0 passes {obj['calls']} "
          f"({obj['with_objects']} with objects), "
          + " / ".join(f"{1e3 * t:.1f}" for t in obj["seconds"])
          + f" ms; render receipts {layer.render_receipts}")
    if got != want or not all(want.values()):
        raise RuntimeError(f"path B's call sites launched {got}, wanted {want}")
    check_scans_fall(m, 0, untrained)
    if final.info is None:
        raise RuntimeError("path B's run() ran no final pass")
    for label, sel in (("optimize frames", True), ("other frames", False)):
        part = [i for i in infos if i["optimized"] == sel]
        print(f"path B, {label} ({len(part)}): tracking "
              f"{1e3 * np.mean([i['tracker_s'] for i in part]):.1f} ms, "
              f"mapping {1e3 * np.mean([i['mapper_s'] for i in part]):.1f} "
              "ms a frame (host clock; the MODE=0 pass synchronised)")
    report_final(system, final.info, result)

    # sem_rgb starts as a class colour (the densified pixel's) and the
    # scans move it; the semantic pass at the last camera against its image
    alive = (m.state.status != gm.DEAD)[:m.state.count]
    rgb = m.state.sem_rgb[:m.state.count][alive]
    classes = torch.as_tensor(CLASS_COLOURS, device=device)
    at_class = (rgb[:, None, :] == classes[None]).all(-1).any(-1)
    moved = float((~at_class).float().mean())
    cin = cams[-1].render_inputs(device)
    with torch.no_grad():
        out = render_state(m.state, cin, m.settings, "global",
                           colors_precomp=m.state.sem_rgb)
    covered = out["depth_index_map"] >= 0
    err = (out["render"] - torch.as_tensor(cams[-1].semantics, device=device)
           ).abs().mean(-1)[covered]
    sem_err = float(err.mean())
    print(f"path B: {int(alive.sum())} Gaussians, sem_rgb moved from its "
          f"sampled class colour on {100 * moved:.1f}%; semantic render at "
          f"frame {len(cams) - 1}: mean error {sem_err:.4f} on "
          f"{100 * float(covered.float().mean()):.1f}% covered pixels; "
          f"whole run {seconds:.2f} s; objects {len(layer.objects)}")
    if not (moved > 0 and math.isfinite(sem_err) and sem_err < 0.25):
        raise RuntimeError(f"path B's semantics off: moved {moved}, "
                           f"error {sem_err}")
    if obj["with_objects"] == 0 or not all(
            np.isfinite(o.ellipsoid_.center_).all() for o in layer.objects):
        raise RuntimeError("path B refined no object in MODE=0")
    return system, scene, {"launches": launches, "seconds": seconds,
                           "result": result, "final": final.info,
                           "obj": obj, "sem_err": sem_err, "moved": moved}


def room_points(scene, n_wall: int = 20000, n_obj: int = 4000, seed: int = 0):
    """Surface points of the synthetic room: its six walls and each
    ellipsoid, with their outward normals; (walls, [per ellipsoid])."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bounds
    walls = []
    for axis in range(3):
        for bound in (lo[axis], hi[axis]):
            p = rng.uniform(lo, hi, (n_wall // 6, 3))
            p[:, axis] = bound
            walls.append(p)
    objs = []
    for o in scene.objects:
        u = rng.normal(size=(n_obj, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pts = u * o["axes"] @ o["R"].T + o["center"]
        nrm = (u / o["axes"]) @ o["R"].T
        objs.append((pts.astype(np.float32),
                     (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                      ).astype(np.float32)))
    return np.concatenate(walls).astype(np.float32), objs


def eval_phase(system, scene, args, card: str):
    """The evaluation CLIs on path B's output, on the card, in process:
    `metric_obj` against a GT box file written from the room's ellipsoids
    (box mode) and against their surface points (per object, the run's
    `_obj<K>.ply` exports), both in the run's frame; `make_mesh` over the run's map along its
    trajectory, scored against the room's surface points; `ablate_assoc` on
    the synthetic sequence; and `per_object_mesh_eval` on the live map."""
    import glob

    import torch
    from dqo_map_tpu_torch.cli import ablate_assoc, make_mesh, metric_obj
    from dqo_map_tpu_torch.eval.obj_eval import per_object_mesh_eval
    from dqo_map_tpu_torch.utils.ply import write_point_normal_ply

    from scipy.spatial.transform import Rotation

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    os.makedirs(EVAL_DIR)
    layer = system.object_layer
    # the run's map lives in its first camera's frame (the tracker starts
    # at the identity), so the ground truth goes there too
    w2r = np.linalg.inv(np.asarray(system.cameras[0].pose_gt, np.float64))
    R0, t0 = w2r[:3, :3], w2r[:3, 3]
    gt_boxes = os.path.join(EVAL_DIR, "gt_boxes.txt")
    with open(gt_boxes, "w") as f:
        for o in scene.objects:
            c = R0 @ o["center"] + t0
            q = Rotation.from_matrix(R0 @ o["R"]).as_quat()      # xyzw
            a = o["axes"]
            f.write(f"{o['category_id']} {c[0]} {c[1]} {c[2]} {q[0]} {q[1]} "
                    f"{q[2]} {q[3]} {a[0]} {a[1]} {a[2]}\n")
    walls, objs = room_points(scene)
    walls = (walls @ R0.T + t0).astype(np.float32)
    objs = [((p @ R0.T + t0).astype(np.float32), (n @ R0.T).astype(np.float32))
            for p, n in objs]
    by_cat = {o["category_id"]: i for i, o in enumerate(scene.objects)}
    gt_mesh, gt_points = [], {}
    for k, o in enumerate(layer.objects):
        if o.category_id_ in by_cat:
            pts, nrm = objs[by_cat[o.category_id_]]
            path = os.path.join(EVAL_DIR, f"gt_obj{k}.ply")
            write_point_normal_ply(path, pts, nrm)
            gt_mesh += ["--gt-mesh", f"{k}={path}"]
            gt_points[k] = pts
    room = os.path.join(EVAL_DIR, "room_points.npy")
    np.save(room, np.concatenate([walls] + [p for p, _ in objs]))
    cfg = os.path.join(EVAL_DIR, "config.yaml")
    with open(cfg, "w") as f:
        # the Synthetic reader's frames over the same orbit
        room_yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "synthetic", "room.yaml")
        f.write(f"parent: {room_yaml}\nframe_num: {args.frames}\n"
                f"save_path: {RUN_B_DIR}\n")
    times = {}

    def timed_call(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    box = timed_call("metric_obj boxes", metric_obj.main, [
        "--pred", os.path.join(RUN_B_DIR, "save_obj", "objects.txt"),
        "--gt", gt_boxes])
    # path A's objects (MODE=1, the same frames and first camera) beside
    box_a = metric_obj.main([
        "--pred", os.path.join(RUN_DIR, "save_obj", "objects.txt"),
        "--gt", gt_boxes])
    per = timed_call("metric_obj per object", metric_obj.main,
                     ["--per-object", RUN_B_DIR, "--dist-thresh", "0.02"]
                     + gt_mesh)
    mesh = timed_call("make_mesh", make_mesh.main, [
        "--config", cfg, "--model", RUN_B_DIR, "--frame-step", "1",
        "--gt-mesh", room])
    ablate = timed_call("ablate_assoc", ablate_assoc.main, [
        "--synthetic", str(args.frames), "--out",
        os.path.join(EVAL_DIR, "ablate")])
    meshes = timed_call("per_object_mesh_eval", per_object_mesh_eval,
                        system.mapping, system.cameras, gt_points)
    print(f"evaluation: boxes {box['n_pred']} predicted / {box['n_gt']} GT, "
          f"mean IoU {box['mean_iou']:.4f}, accuracy@0.25 "
          f"{box['accuracy@0.25']:.3f}, mean AP {box['ap_curve']['mean_ap']:.3f}"
          f", centre error {box['mean_center_err_cm']:.2f} cm; path A's "
          f"objects (MODE=1): {box_a['n_pred']} predicted, mean IoU "
          f"{box_a['mean_iou']:.4f}, centre error "
          f"{box_a['mean_center_err_cm']:.2f} cm [{card}]")
    for k, r in sorted(per.items()):
        print(f"evaluation: object {k} exported points {r['n_points']}, "
              f"accuracy {r.get('accuracy_cm', float('nan')):.2f} cm, "
              f"F1@2cm {r.get('f1', float('nan')):.3f}")
    for k, r in sorted(meshes.items()):
        print(f"evaluation: object {k} TSDF mesh {r.get('n_mesh_verts', 0)} "
              f"vertices, accuracy {r.get('accuracy_cm', float('nan')):.2f} "
              f"cm, completion {r.get('completion_cm', float('nan')):.2f} cm")
    me = mesh.get("mesh_eval", {})
    print(f"evaluation: make_mesh {mesh['vertices']} vertices, {mesh['faces']}"
          f" faces, {mesh['surface_points']} surface points; against the "
          f"room: accuracy {me.get('accuracy_cm', float('nan')):.2f} cm, "
          f"completion {me.get('completion_cm', float('nan')):.2f} cm, "
          f"F1 {me.get('f1', float('nan')):.3f}; ablate_assoc {ablate}; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()) + f" [{card}]")
    scored = [r for r in per.values() if "accuracy_cm" in r]
    if not (box["n_pred"] == len(layer.objects) >= 1
            and math.isfinite(box["mean_iou"]) and scored
            and all(math.isfinite(r["accuracy_cm"]) for r in scored)
            and mesh["faces"] > 0 and math.isfinite(me.get("f1", math.nan))
            and len(ablate) == 3 and all(n >= 1 for _, n, _ in ablate)
            and glob.glob(os.path.join(EVAL_DIR, "ablate", "*", "objects.txt"))):
        raise RuntimeError(f"evaluation phase off: boxes {box}, per object "
                           f"{per}, mesh {mesh}, ablation {ablate}")
    return times


# ---------------------------------------------------------------------------
# path C: data parallelism over the cards
# ---------------------------------------------------------------------------

def run_path_c(args, device, rec):
    """Path C, `SLAMSystem.run()` in `slice_config` with
    `parallel_enabled`, over path A's frames: a mesh of every card, the
    keyframe scans and the final pass through `dp_optimize_scan` (each
    iteration one blend a live keyframe slot; their K1 and K2 launches
    tagged `_dp`), MODE=1's refinement through `shard_objects_refine`.
    Checks the launches against the blends, each data-parallel scan's
    objective falling from its first iteration to its last, the final
    pass's over every keyframe, an object refined through the shards,
    PSNR and ATE. Returns (system, info)."""
    import torch
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.parallel import dp as dp_mod
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    _, cams = synthetic_sequence(args.frames, width=args.width,
                                 height=args.height, with_detections=True)
    shutil.rmtree(RUN_C_DIR, ignore_errors=True)
    system = SLAMSystem(slice_config(RUN_C_DIR, parallel_enabled=True),
                        cameras=cams, device=device)
    m, layer = system.mapping, system.object_layer
    n_dev = torch.cuda.device_count()
    if m.mesh is None or m.mesh.size != n_dev or layer.mesh is not m.mesh:
        raise RuntimeError(f"path C's mesh {m.mesh}, wanted {n_dev} cards "
                           "on the mapper and the object layer")
    inner_scan, inner_shard = dp_mod.dp_optimize_scan, dp_mod.shard_objects_refine
    scans, shards = [], {"calls": 0, "objects": 0}

    def dp_scan(*a, **kw):
        rec.tag = "_dp"
        t0 = time.perf_counter()
        try:
            state, reports = inner_scan(*a, **kw)
        finally:
            rec.tag = None
        torch.cuda.synchronize(device)
        fweight = a[3]
        scans.append({"final": not kw["with_tile_mask"],
                      "slots": len(fweight),
                      "live": sum(1 for w in fweight if w > 0),
                      "iters": reports["iters"], "blends": reports["blends"],
                      "seconds": time.perf_counter() - t0,
                      "curve": (reports["total_loss"]
                                + reports["scale_loss"]).tolist()})
        return state, reports

    def shard(*a, **kw):
        shards["calls"] += 1
        shards["objects"] += int(a[7].sum())          # opt_mask
        return inner_shard(*a, **kw)

    final = FinalPass(system, rec, phase=None)
    m.global_optimization = final
    passes = ColorPasses(system, rec)
    system.save_object_passes = passes
    dp_mod.dp_optimize_scan, dp_mod.shard_objects_refine = dp_scan, shard
    scans0 = dict(m.scan_counts)
    rec.phase, rec.tagged = None, {}
    reset_launches()
    t0 = time.perf_counter()
    try:
        with rec:
            result = system.run(eval_every=args.frames, verbose=False)
        torch.cuda.synchronize(device)
    finally:
        dp_mod.dp_optimize_scan, dp_mod.shard_objects_refine = (inner_scan,
                                                                inner_shard)
        del m.global_optimization, system.save_object_passes
        rec.phase = ""
    seconds = time.perf_counter() - t0
    launches = launches_now()
    check_launches("path C", launches, scans0, m.scan_counts, m.renders,
                   COLOR_PASSES)
    sc = {k: m.scan_counts[k] - scans0[k] for k in m.scan_counts}
    n_final = sum(x["final"] for x in scans)
    blends = sum(x["blends"] for x in scans)
    got = {k: rec.tagged.get(k, 0) for k in PATH_C_ROWS}
    print(f"path C: mesh of {n_dev} card(s); data-parallel scans "
          + "; ".join(f"{'final' if x['final'] else 'keyframe'} {x['iters']} "
                      f"iterations x {x['live']} of {x['slots']} slots, "
                      f"{x['seconds']:.2f} s "
                      f"({1e3 * x['seconds'] / max(x['iters'], 1):.1f} ms an "
                      f"iteration), objective {x['curve'][0]:.5f} -> "
                      f"{x['curve'][-1]:.5f}" for x in scans)
          + f"; tagged launches {got}; shard_objects_refine {shards['calls']} "
          f"calls over {shards['objects']} objects; whole run {seconds:.2f} s")
    # path A's frames make frame 11 a keyframe over a map with stable
    # Gaussians: its keyframe scan runs data-parallel here
    if not (n_final == sc["final"] == 1 and sc["global"] >= 1
            and len(scans) - 1 == sc["global"]):
        raise RuntimeError(f"path C's scans {sc}: {len(scans)} ran "
                           "data-parallel, wanted every keyframe scan (at "
                           "least one) and the final pass")
    if got != {k: blends for k in PATH_C_ROWS} or not blends:
        raise RuntimeError(f"path C's scans launched {got} for {blends} "
                           "blends")
    for x in scans:
        if x["iters"] and not x["curve"][-1] < x["curve"][0]:
            raise RuntimeError(f"a data-parallel scan did not optimise: {x}")
    check_scans_fall(m, 0, kinds=("local",))
    if not (shards["calls"] >= 1 and shards["objects"] >= 1):
        raise RuntimeError(f"path C refined no object through the shards: "
                           f"{shards}")
    if final.info is None:
        raise RuntimeError("path C's run() ran no final pass")
    report_final(system, final.info, result)
    if not (result["psnr"] > 15 and math.isfinite(result["ate_cm"])):
        raise RuntimeError(f"path C's output off: {result}")
    shutil.rmtree(RUN_C_DIR)
    return system, {"scans": scans, "seconds": seconds, "result": result}


# ---------------------------------------------------------------------------
# path D: a Replica-layout sequence through the readers and the run_slam CLI
# ---------------------------------------------------------------------------

def check_fixtures(folder: str, read, what: str, card: str):
    """`read` on every committed fixture of `folder` against the shape (and
    where recorded the dtype), PIL's mode and the SHA-256 of the array PIL
    decodes it to (`hashes.json`, hashed by `make_png_fixtures.py::digest`);
    the palette, 1-bit and CMYK ones also resized by `resize_like_pil` in
    their mode against the hash of PIL's `Image.resize` (NEAREST for the
    first two, band by band for CMYK)."""
    from make_png_fixtures import digest, resize_size
    from dqo_map_tpu_torch.utils.resize import resize_like_pil
    with open(os.path.join(folder, "hashes.json")) as f:
        want = json.load(f)
    bad, resized = [], 0
    for name, w in sorted(want.items()):
        img, mode = read(os.path.join(folder, name))
        ok = (list(img.shape) == w["shape"] and digest(img) == w["sha256"]
              and str(img.dtype) == w.get("dtype", "uint8")
              and mode == w["mode"])
        if ok and "resized" in w:
            small = resize_like_pil(img, resize_size(*img.shape[1::-1]),
                                    mode)
            ok = list(small.shape) == w["resized"]["shape"] and \
                digest(small) == w["resized"]["sha256"]
            resized += 1
        if not ok:
            bad.append(name)
    print(f"{what} on the {len(want)} fixtures of {folder}: "
          f"{len(want) - len(bad)} equal to PIL's arrays and modes, {resized} "
          f"of them resized as PIL resizes their mode [{card}]")
    if bad or not want:
        raise RuntimeError(f"{what} differs from PIL on {bad}")


def check_jpeg_fixtures(card: str):
    """The readers without PIL against PIL's arrays of the committed
    fixtures: `read_jpeg` on the JPEGs (baseline, progressive, Adobe RGB,
    the encoder's references), `read_png` on the PNGs (palette, 1-, 2- and
    4-bit grey, Adam7); `encode_jpeg` on the encoder's input at quality
    75 and 85 (4:2:0 and grey) must write PIL's files byte for byte, and
    so decode to their hashes. Prints `read_jpeg`'s time on the
    progressive 1200x680 room and `encode_jpeg`'s on that frame."""
    from dqo_map_tpu_torch.utils.jpeg import encode_jpeg, read_jpeg
    from dqo_map_tpu_torch.utils.png import read_png
    sys.path.insert(0, os.path.join("tests", "torch_fixtures"))
    from make_jpeg_fixtures import ENCODER, encoder_input
    check_fixtures(JPEG_FIXTURES, read_jpeg, "read_jpeg", card)
    check_fixtures(PNG_FIXTURES, read_png, "read_png", card)
    for name, (kind, q) in sorted(ENCODER.items()):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            want = f.read()
        if encode_jpeg(encoder_input(grey=kind == "grey"), q) != want:
            raise RuntimeError(f"encode_jpeg at quality {q} ({kind}) does not "
                               f"write PIL's {name}")
    print(f"encode_jpeg: PIL's {len(ENCODER)} files byte for byte (quality "
          f"75 and 85, 4:2:0 and grey) [{card}]")
    room = os.path.join(JPEG_FIXTURES, ROOM_PROGRESSIVE)
    frame = read_jpeg(room)[0]
    read_ms, enc_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        read_jpeg(room)
        read_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        encode_jpeg(frame, 75)
        enc_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"read_jpeg {float(np.median(read_ms)):.2f} ms a progressive "
          f"{frame.shape[1]}x{frame.shape[0]} frame "
          f"({os.path.getsize(room) / 1e3:.1f} kB), encode_jpeg "
          f"{float(np.median(enc_ms)):.1f} ms for it at quality 75, 4:2:0 "
          f"(medians of 5, host) [{card}]")
    for name, kind in ((ROOM_ARITH, "arithmetic-coded"),
                       (ROOM_SMOOTH, "progressive, ended after its 4th scan "
                                     "(smoothed)")):
        path = os.path.join(JPEG_FIXTURES, name)
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            img = read_jpeg(path)[0]
            ms.append(1e3 * (time.perf_counter() - t0))
        print(f"read_jpeg {float(np.median(ms)):.2f} ms the "
              f"{img.shape[1]}x{img.shape[0]} room, {kind} "
              f"({os.path.getsize(path) / 1e3:.1f} kB; median of 5, host) "
              f"[{card}]")


# ---------------------------------------------------------------------------
# the no-wait phase: ICP-only tracking in loose sync waits for no device work
# ---------------------------------------------------------------------------

def nowait_phase(args, device, card: str):
    """Path A's configuration with the feature backend off, in loose sync,
    for `NOWAIT_FRAMES` frames through `SLAMSystem.step`. From frame
    `NOWAIT_FROM` on, the tracker's `map_preprocess` and `tracking` run
    under `torch.cuda.set_sync_debug_mode("error")`, so that a
    synchronising call there raises and the phase fails; the mode is
    first shown to raise on a blocking read. The mode does not see every
    wait (an event's among them), so each guarded `tracking` call also
    starts behind `NOWAIT_SLEEP_CYCLES` of spinning queued on the card:
    it must return before its own residual's copy has landed
    (`HostCopy.done()` False) on every guarded frame, which a wait for
    anything queued after the spin would prevent. Prints the tracking
    stage's host ms a frame."""
    import torch
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device=device).item()
        seen = False
    except RuntimeError:
        seen = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not seen:
        raise RuntimeError("the sync debug mode let a blocking read pass")
    _, cams = synthetic_sequence(NOWAIT_FRAMES, width=args.width,
                                 height=args.height, with_detections=True)
    shutil.rmtree(NOWAIT_DIR, ignore_errors=True)
    cfg = slice_config(NOWAIT_DIR)
    cfg.tracking.use_orb_backend = False
    system = SLAMSystem(cfg, cameras=cams, device=device)
    tr = system.tracker
    if tr.pose_backend is not None or system.sync_method != "loose":
        raise RuntimeError("the no-wait phase needs ICP alone in loose sync")
    frame_at, early = [0], []

    def guarded(fn, track: bool):
        def call(*a, **kw):
            if frame_at[0] < NOWAIT_FROM:
                return fn(*a, **kw)
            if track:
                torch.cuda._sleep(NOWAIT_SLEEP_CYCLES)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if track:
                early.append(not tr._pending_p2p.done())
            return out
        return call

    tr.map_preprocess = guarded(tr.map_preprocess, False)
    tr.tracking = guarded(tr.tracking, True)
    reset_launches()
    ms = []
    for i, cam in enumerate(cams):
        frame_at[0] = i
        info = system.step(cam, i)
        system.mapping.time += 1
        ms.append(1e3 * info["tracker_s"])
    torch.cuda.synchronize()
    launches = launches_now()
    ate = tr.eval_ate_series()
    checked = ms[NOWAIT_FROM:]
    print(f"no-wait phase (ICP alone, loose sync, {NOWAIT_FRAMES} frames at "
          f"{args.width}x{args.height}): map_preprocess and tracking made no "
          f"synchronising call on frames {NOWAIT_FROM}-{NOWAIT_FRAMES - 1} "
          f"(sync debug mode 'error'); behind ~1 s of spinning on the card, "
          f"tracking returned before its residual copy landed on "
          f"{sum(early)} of {len(early)}; tracker "
          f"{float(np.median(checked)):.2f} ms a frame (median; "
          f"{', '.join(f'{x:.2f}' for x in checked)}), frames 0-"
          f"{NOWAIT_FROM - 1}: {', '.join(f'{x:.2f}' for x in ms[:NOWAIT_FROM])} "
          f"ms; ICP failures {tr.icp_fail_count}; ATE {ate:.4f} cm; launches "
          f"{launches} [{card}]")
    if len(early) != NOWAIT_FRAMES - NOWAIT_FROM or not all(early) or \
            not ate < 1.0 or not launches.get("blend_fwd"):
        raise RuntimeError(f"the no-wait phase is off: guarded frames "
                           f"returning early {early}, ATE {ate} cm, "
                           f"{launches}")
    shutil.rmtree(NOWAIT_DIR, ignore_errors=True)


def write_replica(cams, root: str) -> list:
    """The frames in Replica's layout under `root`: `office0/results/
    frame%06d.jpg` (`write_jpeg`, quality 95, 4:2:0) and `depth%06d.png`
    (16-bit at `REPLICA_SCALE`), `office0/traj.txt` (each camera-to-world
    pose, row-major) and `cam_params.json` beside `office0/`. Returns the
    16-bit depth frames written."""
    from dqo_map_tpu_torch.utils.jpeg import write_jpeg
    from dqo_map_tpu_torch.utils.png import write_png
    shutil.rmtree(root, ignore_errors=True)
    results = os.path.join(root, "office0", "results")
    os.makedirs(results)
    c = cams[0]
    with open(os.path.join(root, "cam_params.json"), "w") as f:
        json.dump({"camera": {"w": c.width, "h": c.height, "fx": c.fx,
                              "fy": c.fy, "cx": c.cx, "cy": c.cy,
                              "scale": REPLICA_SCALE}}, f)
    depths, lines = [], []
    for i, cam in enumerate(cams):
        rgb = np.clip(np.rint(cam.image * 255), 0, 255).astype(np.uint8)
        write_jpeg(os.path.join(results, f"frame{i:06d}.jpg"), rgb, 95,
                   "4:2:0")
        d16 = np.clip(np.rint(cam.depth * REPLICA_SCALE), 0,
                      65535).astype(np.uint16)
        write_png(os.path.join(results, f"depth{i:06d}.png"), d16)
        depths.append(d16)
        lines.append(" ".join(repr(float(v)) for v in cam.pose_gt.reshape(-1)))
    with open(os.path.join(root, "office0", "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return depths


def run_path_d(cams, result_a: dict, seconds_a: float, card: str):
    """Path D: path A's frames written in Replica's layout at their full
    size; the port's Replica reader must return the written depth exactly
    and the colour at least `MIN_JPEG_PSNR` dB from its source; then the
    run_slam CLI on a child of `configs/replica/office0.yaml` (12 frames)
    on the card as a subprocess, which must exit 0, write `result.json`
    and the trajectory, and launch K1 and K2, both variants."""
    import torch
    from dqo_map_tpu_torch.data.readers import read_replica
    from dqo_map_tpu_torch.utils.jpeg import read_jpeg
    from dqo_map_tpu_torch.utils.resize import resize_like_pil
    check_jpeg_fixtures(card)
    t0 = time.perf_counter()
    depths = write_replica(cams, REPLICA_DIR)
    scene = os.path.join(REPLICA_DIR, "office0")
    write_s = time.perf_counter() - t0
    read = read_replica(scene, frame_num=len(cams))
    if len(read) != len(cams):
        raise RuntimeError(f"read_replica read {len(read)} frames of "
                           f"{len(cams)}")
    psnrs = []
    for cam, got, d16 in zip(cams, read, depths):
        if not np.array_equal(got.depth, d16.astype(np.float32) /
                              REPLICA_SCALE):
            raise RuntimeError(f"frame {got.uid}: the depth read is not the "
                               "written 16-bit values over the scale")
        mse = float(np.mean((got.image - cam.image) ** 2))
        psnrs.append(10 * math.log10(1.0 / mse))
    jpgs = sorted(os.listdir(os.path.join(scene, "results")))
    jpgs = [os.path.join(scene, "results", j) for j in jpgs
            if j.endswith(".jpg")]
    decode_ms = []
    for j in jpgs:
        t0 = time.perf_counter()
        read_jpeg(j)
        decode_ms.append(1e3 * (time.perf_counter() - t0))
    big = np.random.default_rng(0).integers(0, 256, (1440, 1920, 3),
                                            dtype=np.uint8)
    resize_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        resize_like_pil(big, (256, 192))
        resize_ms.append(1e3 * (time.perf_counter() - t0))
    c = cams[0]
    kb = sum(os.path.getsize(j) for j in jpgs) / len(jpgs) / 1e3
    print(f"path D: {len(cams)} frames of {c.width}x{c.height} written in "
          f"Replica's layout in {write_s:.2f} s ({kb:.1f} kB a JPEG); "
          f"read_replica: depth exact, colour PSNR {min(psnrs):.2f}-"
          f"{max(psnrs):.2f} dB against the source [{card}]")
    print(f"path D: read_jpeg {float(np.median(decode_ms)):.2f} ms of host "
          f"a {c.width}x{c.height} frame (median of {len(decode_ms)}; min "
          f"{min(decode_ms):.2f}, max {max(decode_ms):.2f}); resize_like_pil "
          f"1920x1440 -> 256x192 {float(np.median(resize_ms)):.1f} ms "
          f"(median of 3) [{card}]")
    if min(psnrs) < MIN_JPEG_PSNR:
        raise RuntimeError(f"the written colour is {min(psnrs):.2f} dB from "
                           f"its source, under {MIN_JPEG_PSNR}")

    shutil.rmtree(RUN_D_DIR, ignore_errors=True)
    cfg = os.path.join(REPLICA_DIR, "office0.yaml")
    with open(cfg, "w") as f:
        # the repo's office0 configuration, on the written sequence
        f.write("parent: configs/replica/office0.yaml\n"
                f"source_path: {scene}\nsave_path: {RUN_D_DIR}\n"
                f"frame_num: {len(cams)}\n")
    cmd = [sys.executable, "-c", RUN_SLAM_COUNTED, "--config", cfg, "--quiet"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"run_slam on {cfg} exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    tagged = {line.split(" ", 1)[0]: json.loads(line.split(" ", 1)[1])
              for line in res.stdout.splitlines()
              if line.startswith(("RUN_S ", "LAUNCHES "))}
    launches, run_s = tagged["LAUNCHES"], tagged["RUN_S"]
    with open(os.path.join(RUN_D_DIR, "result.json")) as f:
        result = json.load(f)
    traj = os.path.join(RUN_D_DIR, "save_traj", "pose_es.npy")
    print(f"path D: run_slam on {cfg} (configs/replica/office0.yaml, "
          f"{len(cams)} frames): exit 0 in {wall:.1f} s; run() "
          f"{run_s[0]:.2f} s against path A's {seconds_a:.2f} s; launches "
          f"{launches} [{card}]")
    print(f"path D at frame {len(cams) - 1}, after the final pass: PSNR "
          f"{result['psnr']:.2f} dB, depth-L1 {result['depth_l1_cm']:.3f} cm, "
          f"ATE {result['ate_cm']:.4f} cm; path A's {result_a['psnr']:.2f} "
          f"dB, {result_a['depth_l1_cm']:.3f} cm, {result_a['ate_cm']:.4f} cm "
          f"[{card}]")
    missing = [k for k in KERNELS if not launches.get(k)]
    quality_ok = all(math.isfinite(result[k]) for k in
                     ("psnr", "depth_l1_cm", "ate_cm")) and result["psnr"] > 15
    if missing or not quality_ok or len(run_s) != 1 or \
            len(np.load(traj)) != len(cams):
        raise RuntimeError(f"path D off: kernels never launched {missing}, "
                           f"result {result}, run() calls {len(run_s)}")
    # the frames are remade by every run; the run's own outputs stay
    shutil.rmtree(os.path.join(REPLICA_DIR, "office0"))
    shutil.rmtree(os.path.join(RUN_D_DIR, "save_model"), ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's main path runs on one",
              file=sys.stderr)
        return 1
    print(card_line())
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from dqo_map_tpu_torch.ops.cuda_build import build_libraries
    from dqo_map_tpu_torch.slam.pose_backend import build_library
    t0 = time.perf_counter()
    libs = build_libraries(verbose=True)
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lib = build_library()
    print(f"built the feature backend {lib.name} with g++ in "
          f"{time.perf_counter() - t0:.1f} s; {card_line()}")
    from dqo_map_tpu_torch.utils.jpeg import build_library as build_decoder
    t0 = time.perf_counter()
    lib = build_decoder()
    print(f"built the JPEG decoder {lib.name} with g++ in "
          f"{time.perf_counter() - t0:.1f} s")
    knn_row = knn_phase(device)

    rec = Recorder()
    (system, cams, infos, final, result, tail, launches, seconds, window,
     host, passes, k3, k4) = run_main_path(args, device, rec)
    knn_row.update(knn_path_a(k3))
    m = system.mapping
    check_count_reads(infos, m)
    # the map `run()` ended with, which the keyframe path below may change
    from dqo_map_tpu_torch.models.gaussian_map import FIELDS
    final_state = m.state.replace(**{f: getattr(m.state, f).clone()
                                     for f in FIELDS})
    extra = (keyframe_phase(system, device, rec)
             if m.scan_counts["global"] == 0 else None)
    print(f"scans run: local {m.scan_counts['local']}, keyframe "
          f"{m.scan_counts['global']}, final {m.scan_counts['final']}; Adam "
          f"steps {m.scan_counts['iters']}")
    if m.scan_counts["local"] == 0 or m.scan_counts["global"] == 0:
        raise RuntimeError(f"a scan kind never ran: {m.scan_counts}")
    for k in KERNELS:
        if launches[k] == 0 and not (extra and extra[k]):
            raise RuntimeError(f"{k} was never launched on the main path "
                               "or the keyframe path")

    card = card_line()
    report_times(system, infos, final, tail, seconds, window, passes, card)
    report_tracking_objects(system, infos, host, result, card)
    u, st = m.counts()
    rec_ = m.receipts
    print(f"alive gaussians {u + st} (stable {st}); live entries last render "
          f"{infos[-1]['render']['num_entries']}, max {rec_['num_entries']}; "
          f"dropped {rec_['dropped_entries']}, tile_dropped "
          f"{rec_['tile_dropped']}, clipped cells {rec_['clipped_cells']}")
    q = quality(system, cams, infos)
    print(f"frame {len(cams) - 1}: PSNR {q['psnr']:.2f} dB, depth-L1 "
          f"{q['depth_l1_cm']:.2f} cm; ATE {q['ate_cm']:.4f} cm; "
          f"ICP failures {q['icp_fail_count']}")
    if not (u + st > 0 and q["psnr"] > 15.0 and math.isfinite(q["ate_cm"])):
        raise RuntimeError(f"main path output off: {q}, alive {u + st}")
    report_final(system, final, result)
    merge_ply = check_outputs(system)

    # K1 on the final map at the last camera, as the model render calls it
    from dqo_map_tpu_torch.ops.rasterize import blend_inputs, blend_params
    from dqo_map_tpu_torch.slam.renderer import state_render_args
    s = m.settings
    cin = cams[-1].render_inputs(device)
    with torch.no_grad():
        _, b, feats = blend_inputs(cam=cin, settings=s,
                                   **state_render_args(final_state, cin, s))
    T = b.tile_offsets.shape[0] - 1
    fwd_args = (feats, b.tile_offsets, b.tile_counts, T, s.tile_size,
                s.width, cin["K"], blend_params(s), s.bg)
    # each recorded call's entry layout: the keyframe scan and the model
    # renders bin with `settings`, the local scans with `usettings`
    layout = {k: (st.chunk, st.max_chunks_per_tile) for k, st in (
        ("blend_fwd", s), ("blend_bwd", s), ("blend_fwd_bg", m.usettings),
        ("blend_bwd_bg", m.usettings))}
    layout["blend_fwd_final"] = layout["blend_bwd_final"] = layout["blend_fwd"]
    final_launches = {"blend_fwd_final": final["launches"]["blend_fwd"],
                      "blend_bwd_final": final["launches"]["blend_bwd"]}
    with torch.no_grad():
        rows = [check_fwd("blend_fwd", fwd_args, {"tile_order": b.tile_order},
                          launches["blend_fwd"], layout["blend_fwd"])]
        for name in KERNELS[1:] + FINAL_ROWS:
            a, kw = rec.last[name]
            check = check_bwd if "bwd" in name else check_fwd
            rows.append(check(name, a, kw,
                              final_launches.get(name, launches.get(name)),
                              layout[name]))
        # K1 at the colour-pass call site: the instance pass on the final
        # map at the last camera, as `run()` made it
        from dqo_map_tpu_torch.slam.renderer import palette_color
        _, bc, fc = blend_inputs(cam=cin, settings=s, **state_render_args(
            final_state, cin, s,
            colors_precomp=palette_color(final_state.obj_id)))
        rows.append(check_fwd(
            "blend_fwd_colorpass",
            (fc,) + (bc.tile_offsets, bc.tile_counts) + fwd_args[3:],
            {"tile_order": bc.tile_order}, passes.launches["blend_fwd"],
            layout["blend_fwd"]))
    if extra:
        for row in rows:
            row["keyframe_path_launches"] = extra.get(row["name"], 0)
    project_row = project_phase(final_state, cin, s)
    project_row["launches"] = k4

    ply_round_trip(system, final_state, cin, merge_ply)
    checkpoint_round_trip(system, cams, cin, device)
    cli_phase(merge_ply, card, device)

    # path B: the semantic and instance losses and MODE=0, its call sites
    # of K1 and K2 held like path A's, then the evaluation CLIs on its run
    del system, final_state
    system_b, scene, _ = run_path_b(args, device, rec)
    mb = system_b.mapping
    layout_b = {k: (st.chunk, st.max_chunks_per_tile) for k, st in (
        ("blend_fwd_sem", mb.usettings), ("blend_bwd_sem", mb.usettings),
        ("blend_fwd_obj", mb.settings), ("blend_bwd_obj", mb.settings))}
    with torch.no_grad():
        for name in PATH_B_ROWS:
            a, kw = rec.last[name]
            check = check_bwd if "bwd" in name else check_fwd
            rows.append(check(name, a, kw, rec.tagged[name], layout_b[name]))
    eval_phase(system_b, scene, args, card)

    # path C: the keyframe scans and the final pass data-parallel over the
    # cards, their K1 and K2 launches held like path B's
    del system_b, scene
    rec.last.clear()
    system_c, _ = run_path_c(args, device, rec)
    st_c = system_c.mapping.settings
    with torch.no_grad():
        for name in PATH_C_ROWS:
            a, kw = rec.last[name]
            check = check_bwd if "bwd" in name else check_fwd
            rows.append(check(name, a, kw, rec.tagged[name],
                              (st_c.chunk, st_c.max_chunks_per_tile)))
    del system_c
    rec.last.clear()
    # path D: path A's frames read back from Replica's layout, and the
    # run_slam CLI on office0's configuration over them
    run_path_d(cams, result, seconds, card)
    nowait_phase(args, device, card)
    print(card_line())
    print(json.dumps({"kernels": rows + [knn_row, project_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
