"""The blend on the card: the wrappers of the two hand-written kernels,
`csrc/blend_fwd.cu` (K1, the forward, with and without the one-surface
background) and `csrc/blend_bwd.cu` (K2, its backward), and the
`torch.autograd.Function` around them (counterpart of
`dqo_map_tpu/ops/blend_pallas.py`: `pack_entries`, `_blend_core` with its
custom VJP, `blend_tiles_pallas`; the empty-tile paste is the kernels' own
init values, written by the CTA of a tile with no entries).

Each source is built with `nvcc` for `sm_90a` at first use, the two in
parallel, into `dqo_map_tpu_torch/_build/`, and bound with ctypes. For
tensors on the card the Function launches the kernels or raises; for
tensors on the CPU it runs the plain versions (`blend.blend_blocks_ref`,
`blend.blend_bwd_ref`). Each wrapper adds one to its entry of `LAUNCHES`
where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .blend import (ALPHA_MAX, ALPHA_MIN, NA, NB, NC, NF, BlendParams,
                    blend_blocks_ref, blend_bwd_ref, gather_entry_feats,
                    unpack_blocks)

PKG = Path(__file__).resolve().parent.parent
SOURCES = {"blend_fwd": PKG / "csrc" / "blend_fwd.cu",
           "blend_bwd": PKG / "csrc" / "blend_bwd.cu"}
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# launches per kernel variant, counted where each wrapper launches
LAUNCHES = dict.fromkeys(("blend_fwd", "blend_fwd_bg", "blend_bwd",
                          "blend_bwd_bg"), 0)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the blend kernels are built for "
                           "sm_90a at first use and need the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    tag = hashlib.sha256(SOURCES[name].read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_libraries(verbose: bool = False) -> dict:
    """Compile each source of `SOURCES` into `_build/` unless a library of
    the same source and flags is already there, one nvcc per source, all
    started together. Returns {name: path}; with `verbose`, prints what
    `-Xptxas -v` says of each."""
    out = {name: _target(name) for name in SOURCES}
    todo = {name: p for name, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(f"{name}: {err.strip()}")
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_LIBS: dict = {}


def _lib(name: str):
    if not _LIBS:
        paths = build_libraries()
        P, F, I, LL = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
        fwd = ctypes.CDLL(str(paths["blend_fwd"]))
        fwd.dqo_blend_fwd.argtypes = [P, LL, P, P, P, I, I, P, F, F, F, F, F,
                                      F, F, F, F, P, P, P, P, P]
        fwd.dqo_blend_fwd.restype = I
        bwd = ctypes.CDLL(str(paths["blend_bwd"]))
        bwd.dqo_blend_bwd.argtypes = [P, LL, P, P, P, I, I, P, F, F, F, F, F,
                                      F, F, F, F, P, P, P, P, P, P]
        bwd.dqo_blend_bwd.restype = I
        for lib in (fwd, bwd):
            lib.dqo_cuda_error_string.argtypes = [I]
            lib.dqo_cuda_error_string.restype = ctypes.c_char_p
        _LIBS.update(blend_fwd=fwd, blend_bwd=bwd)
    return _LIBS[name]


def pack_entries(pre, b, colors, opacities) -> torch.Tensor:
    """Feature-major (16, L) entry features of a binning; padding entries
    get opacity 0, which doubles as the validity lane."""
    return gather_entry_feats(
        b.point_list, b.entry_valid, pre.xy, pre.conic, opacities, colors,
        pre.depth, pre.mean_c, pre.normal_c, pre.scale_max).contiguous()


def _check_common(name, feats, tile_offsets, tile_counts, num_tiles,
                  tile_size, bgt):
    """The arguments both kernels read: every tensor the kernel reads by
    pointer on `feats`' device, which must be a card (K's four scalars are
    copied there)."""
    if tile_size != 16:
        raise ValueError(f"the kernels blend 16x16 tiles, got {tile_size}")
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[0] != NF:
        raise ValueError(f"feats must be float32 (16, L), got "
                         f"{feats.dtype} {tuple(feats.shape)}")
    if tile_offsets.dtype != torch.int64 or tile_offsets.shape != (num_tiles + 1,):
        raise ValueError("tile_offsets must be int64 (num_tiles + 1,)")
    if tile_counts.dtype != torch.int64 or tile_counts.shape != (num_tiles,):
        raise ValueError("tile_counts must be int64 (num_tiles,)")
    for what, x in (("tile_offsets", tile_offsets),
                    ("tile_counts", tile_counts)):
        if x.device != feats.device:
            raise ValueError(f"{what} must be on feats' device "
                             f"{feats.device}, got {x.device}")
    if bgt is not None:
        _check_block("bgt", bgt, num_tiles, NB, feats.device)
    if not feats.is_cuda:
        raise ValueError(f"{name} runs on the card; the plain version takes "
                         "CPU tensors")


def _check_block(what, x, num_tiles, channels, device):
    if (x.dtype != torch.float32 or x.shape != (num_tiles, 256, channels)
            or not x.is_contiguous() or x.device != device):
        raise ValueError(f"{what} must be a contiguous float32 "
                         f"({num_tiles}, 256, {channels}) tensor on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what} must start on 16 bytes: the kernels read "
                         "it as float4")


def _check_order(tile_order, num_tiles, device):
    """The launch order, CTA i on tile `tile_order[i]`: int64 (num_tiles,)
    on `device`, or None for tile order."""
    if tile_order is None:
        return None
    if tile_order.dtype != torch.int64 or tile_order.shape != (num_tiles,):
        raise ValueError(f"tile_order must be int64 (num_tiles,) = "
                         f"({num_tiles},), got {tile_order.dtype} "
                         f"{tuple(tile_order.shape)}")
    if tile_order.device != device:
        raise ValueError(f"tile_order must be on {device}, got "
                         f"{tile_order.device}")
    return tile_order.contiguous()


def _scal(K, dev):
    return torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(
        device=dev, dtype=torch.float32).contiguous()


def _raise_on(rc: int, lib, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.dqo_cuda_error_string(rc).decode())


def blend_fwd(feats: torch.Tensor, tile_offsets: torch.Tensor,
              tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
              width: int, K: torch.Tensor, params: BlendParams, bg,
              bgt: Optional[torch.Tensor] = None,
              tile_order: Optional[torch.Tensor] = None):
    """Launch K1, one CTA per tile, CTA i on tile `tile_order[i]` (the
    binning's order, most entries first, so the crowded tiles start first
    and the empty ones last; tile i without it), each walking its tile's
    `tile_counts[t]` live entries from `tile_offsets[t]` on, in staged
    batches, a warp of pixels leaving once all its pixels are done; with
    `bgt` (num_tiles, 256, 8) the variant with the one-surface background.
    Returns the per-tile blocks color (T, 256, 8) and aux (T, 256, 8),
    each CTA writing its tile's rows as whole lines, and n_touched per
    entry (L,) int32; a tile with no entries gets the init values."""
    dev = feats.device
    tile_order = _check_order(tile_order, num_tiles, dev)
    _check_common("blend_fwd", feats, tile_offsets, tile_counts, num_tiles,
                  tile_size, bgt)
    feats = feats.contiguous()
    tile_offsets = tile_offsets.contiguous()
    tile_counts = tile_counts.contiguous()
    L = feats.shape[1]
    n_px = tile_size * tile_size
    bg = [float(x) for x in bg]
    TW = (width + tile_size - 1) // tile_size
    lib = _lib("blend_fwd")
    # the kernel launches on the current device: make it the tensors' one
    with torch.cuda.device(dev):
        scal = _scal(K, dev)
        color = torch.empty((num_tiles, n_px, NC), dtype=torch.float32,
                            device=dev)
        aux = torch.empty((num_tiles, n_px, NA), dtype=torch.float32,
                          device=dev)
        nt = torch.zeros(L, dtype=torch.int32, device=dev)
        rc = lib.dqo_blend_fwd(
            feats.data_ptr(), L, tile_offsets.data_ptr(),
            tile_counts.data_ptr(),
            None if tile_order is None else tile_order.data_ptr(), num_tiles,
            TW, scal.data_ptr(),
            params.opaque_threshold, params.depth_threshold,
            params.normal_threshold, params.T_threshold, ALPHA_MIN, ALPHA_MAX,
            bg[0], bg[1], bg[2], None if bgt is None else bgt.data_ptr(),
            color.data_ptr(), aux.data_ptr(), nt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "blend_fwd")
    LAUNCHES["blend_fwd" if bgt is None else "blend_fwd_bg"] += 1
    return color, aux, nt


def blend_bwd(feats: torch.Tensor, tile_offsets: torch.Tensor,
              tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
              width: int, K: torch.Tensor, params: BlendParams, bg,
              color: torch.Tensor, aux: torch.Tensor, dcolor: torch.Tensor,
              bgt: Optional[torch.Tensor] = None,
              tile_order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2, one CTA per tile, CTA i on tile `tile_order[i]` (the
    binning's order, most entries first; tile i without it): the cotangent
    `dcolor` (T, 256, 8) of K1's colour block taken back to the (16, L)
    entry features, from K1's saved `color` and `aux` blocks. Returns
    dfeats (16, L), 0 on padding and on rows 13 and 14."""
    dev = feats.device
    tile_order = _check_order(tile_order, num_tiles, dev)
    _check_common("blend_bwd", feats, tile_offsets, tile_counts, num_tiles,
                  tile_size, bgt)
    for what, x, ch in (("color", color, NC), ("aux", aux, NA),
                        ("dcolor", dcolor, NC)):
        _check_block(what, x, num_tiles, ch, dev)
    feats = feats.contiguous()
    tile_offsets = tile_offsets.contiguous()
    tile_counts = tile_counts.contiguous()
    L = feats.shape[1]
    bg = [float(x) for x in bg]
    TW = (width + tile_size - 1) // tile_size
    lib = _lib("blend_bwd")
    # the kernel launches on the current device: make it the tensors' one
    with torch.cuda.device(dev):
        scal = _scal(K, dev)
        dfeats = torch.zeros((NF, L), dtype=torch.float32, device=dev)
        rc = lib.dqo_blend_bwd(
            feats.data_ptr(), L, tile_offsets.data_ptr(),
            tile_counts.data_ptr(),
            None if tile_order is None else tile_order.data_ptr(), num_tiles,
            TW, scal.data_ptr(),
            params.opaque_threshold, params.depth_threshold,
            params.normal_threshold, params.T_threshold, ALPHA_MIN, ALPHA_MAX,
            bg[0], bg[1], bg[2], None if bgt is None else bgt.data_ptr(),
            dcolor.data_ptr(), color.data_ptr(), aux.data_ptr(),
            dfeats.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "blend_bwd")
    LAUNCHES["blend_bwd" if bgt is None else "blend_bwd_bg"] += 1
    return dfeats


class Geometry(NamedTuple):
    """The blend's non-tensor arguments."""
    num_tiles: int
    tile_size: int
    width: int
    params: BlendParams
    bg: tuple


class BlendFunction(torch.autograd.Function):
    """The blend as a differentiable function of the (16, L) entry features:
    K1 forward, K2 backward on the card; the plain versions on the CPU. The
    colour block (rgb, hit depth, hit normal) carries the gradient; aux and
    n_touched are constants."""

    @staticmethod
    def forward(ctx, feats, tile_offsets, tile_counts, tile_order, K, bgt,
                geom: Geometry):
        args = (feats, tile_offsets, tile_counts, geom.num_tiles,
                geom.tile_size, geom.width, K, geom.params, geom.bg)
        if feats.is_cuda:
            color, aux, nt = blend_fwd(*args, bgt=bgt, tile_order=tile_order)
        else:
            color, aux, nt = blend_blocks_ref(*args, bgt=bgt)
        ctx.save_for_backward(feats, tile_offsets, tile_counts, tile_order, K,
                              bgt, color, aux)
        ctx.geom = geom
        ctx.mark_non_differentiable(aux, nt)
        return color, aux, nt

    @staticmethod
    def backward(ctx, dcolor, _daux, _dnt):
        (feats, tile_offsets, tile_counts, tile_order, K, bgt, color,
         aux) = ctx.saved_tensors
        g = ctx.geom
        args = (feats, tile_offsets, tile_counts, g.num_tiles, g.tile_size,
                g.width, K, g.params, g.bg, color, aux, dcolor.contiguous())
        if feats.is_cuda:
            dfeats = blend_bwd(*args, bgt=bgt, tile_order=tile_order)
        else:
            dfeats = blend_bwd_ref(*args, bgt=bgt)
        return dfeats, None, None, None, None, None, None


def blend_tiles(feats: torch.Tensor, tile_offsets: torch.Tensor,
                tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
                width: int, height: int, K: torch.Tensor, params: BlendParams,
                bg, bgt: Optional[torch.Tensor] = None,
                tiled: bool = False,
                tile_order: Optional[torch.Tensor] = None) -> dict:
    """Blend every tile, differentiably in `feats`: the kernels for tensors
    on the card, the plain versions for tensors on the CPU; `tile_order` is
    both kernels' launch order (`blend_fwd`, `blend_bwd`). Returns the maps of
    `blend.unpack_blocks`, as images or, `tiled`, as tile rows."""
    geom = Geometry(num_tiles, tile_size, width, params,
                    tuple(float(x) for x in bg))
    color, aux, nt = BlendFunction.apply(feats, tile_offsets, tile_counts,
                                         tile_order, K, bgt, geom)
    return unpack_blocks(color, aux, nt, tile_size, width, height, tiled)
