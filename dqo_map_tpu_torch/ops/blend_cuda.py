"""The forward blend on the card: the wrapper of `csrc/blend_fwd.cu` and the
layout around it (counterpart of `dqo_map_tpu/ops/blend_pallas.py`'s
forward: `pack_entries`, `blend_tiles_pallas`; the empty-tile paste is the
kernel's own init values, written by the CTA of a tile with no entries).

The library is built with `nvcc` for `sm_90a` at its first use, from the
source in this package, into `dqo_map_tpu_torch/_build/`, and bound with
ctypes. `blend_tiles` runs the kernel for tensors on the card and the plain
version (`blend.blend_tiles_ref`) for tensors on the CPU; for a tensor on
the card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .blend import (ALPHA_MAX, ALPHA_MIN, NF, BlendParams, blend_tiles_ref,
                    gather_entry_feats, untile_map)

PKG = Path(__file__).resolve().parent.parent
SRC = PKG / "csrc" / "blend_fwd.cu"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
NC = 8               # colour block: rgb, hit depth, hit normal_c, pad
NA = 8               # aux: hit id, colour id, colour w, hit w, end_T, wsum,
                     #      T_final, hit depth


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the blend kernel is built for "
                           "sm_90a at first use and needs the CUDA toolkit")
    return found


def build_library(verbose: bool = False) -> Path:
    """Compile `csrc/blend_fwd.cu` into `_build/` unless a library of the
    same source and flags is already there. Returns its path."""
    tag = hashlib.sha256(SRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libblend_fwd_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.dqo_blend_fwd.argtypes = [P, ctypes.c_longlong, P, P, I, I, P,
                                      F, F, F, F, F, F, F, F, F, P, P, P, P]
        lib.dqo_blend_fwd.restype = I
        lib.dqo_cuda_error_string.argtypes = [I]
        lib.dqo_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def pack_entries(pre, b, colors, opacities) -> torch.Tensor:
    """Feature-major (16, L) entry features of a binning; padding entries
    get opacity 0, which doubles as the validity lane."""
    return gather_entry_feats(
        b.point_list, b.entry_valid, pre.xy, pre.conic, opacities, colors,
        pre.depth, pre.mean_c, pre.normal_c, pre.scale_max).contiguous()


def blend_fwd(feats: torch.Tensor, tile_offsets: torch.Tensor,
              tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
              width: int, K: torch.Tensor, params: BlendParams, bg):
    """Launch the forward blend kernel, one CTA per tile, each walking its
    tile's `tile_counts[t]` live entries from `tile_offsets[t]` on. Returns
    the per-tile blocks color (T, 256, 8), aux (T, 256, 8) and n_touched
    per entry (L,) int32; a tile with no entries gets the init values."""
    if not feats.is_cuda:
        raise ValueError("blend_fwd runs on the card; use blend_tiles_ref "
                         "for CPU tensors")
    if tile_size != 16:
        raise ValueError(f"the kernel blends 16x16 tiles, got {tile_size}")
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[0] != NF:
        raise ValueError(f"feats must be float32 (16, L), got "
                         f"{feats.dtype} {tuple(feats.shape)}")
    if tile_offsets.dtype != torch.int64 or tile_offsets.shape != (num_tiles + 1,):
        raise ValueError("tile_offsets must be int64 (num_tiles + 1,)")
    if tile_counts.dtype != torch.int64 or tile_counts.shape != (num_tiles,):
        raise ValueError("tile_counts must be int64 (num_tiles,)")
    dev = feats.device
    feats = feats.contiguous()
    tile_offsets = tile_offsets.to(dev).contiguous()
    tile_counts = tile_counts.to(dev).contiguous()
    L = feats.shape[1]
    n_px = tile_size * tile_size
    scal = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(
        device=dev, dtype=torch.float32).contiguous()
    color = torch.empty((num_tiles, n_px, NC), dtype=torch.float32, device=dev)
    aux = torch.empty((num_tiles, n_px, NA), dtype=torch.float32, device=dev)
    nt = torch.zeros(L, dtype=torch.int32, device=dev)
    bg = [float(x) for x in bg]
    TW = (width + tile_size - 1) // tile_size
    rc = _lib().dqo_blend_fwd(
        feats.data_ptr(), L, tile_offsets.data_ptr(), tile_counts.data_ptr(),
        num_tiles, TW, scal.data_ptr(),
        params.opaque_threshold, params.depth_threshold,
        params.normal_threshold, params.T_threshold, ALPHA_MIN, ALPHA_MAX,
        bg[0], bg[1], bg[2], color.data_ptr(), aux.data_ptr(),
        nt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("blend_fwd launch failed: "
                           + _lib().dqo_cuda_error_string(rc).decode())
    blend_fwd.launches += 1
    return color, aux, nt


blend_fwd.launches = 0


def unpack_blocks(color, aux, nt, tile_size: int, width: int, height: int) -> dict:
    """The kernel's per-tile blocks as the image maps of `blend_tiles_ref`."""
    def pick(x, c):
        return untile_map(x[:, :, c], tile_size, width, height)

    return {
        "render": untile_map(color[:, :, 0:3], tile_size, width, height),
        "depth": pick(color, 3),
        "normal_c": untile_map(color[:, :, 4:7], tile_size, width, height),
        "depth_index_map": torch.round(pick(aux, 0)).int(),
        "color_index_map": torch.round(pick(aux, 1)).int(),
        "color_hit_weight": pick(aux, 2),
        "depth_hit_weight": pick(aux, 3),
        "T_map": pick(aux, 4),
        "weight_sum": pick(aux, 5),
        "T_final": pick(aux, 6),
        "n_touched_entries": nt,
    }


def blend_tiles(feats: torch.Tensor, tile_offsets: torch.Tensor,
                tile_counts: torch.Tensor, num_tiles: int, tile_size: int,
                width: int, height: int, K: torch.Tensor, params: BlendParams,
                bg) -> dict:
    """Blend every tile: the kernel for tensors on the card, the plain
    version for tensors on the CPU. Same maps either way."""
    if feats.is_cuda:
        return unpack_blocks(*blend_fwd(feats, tile_offsets, tile_counts,
                                        num_tiles, tile_size, width, K,
                                        params, bg),
                             tile_size, width, height)
    return blend_tiles_ref(feats, tile_offsets, tile_counts, num_tiles,
                           tile_size, width, height, K, params, bg)
