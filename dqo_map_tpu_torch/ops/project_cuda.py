"""K4 on the card: the render's per-Gaussian chain, from the map's leaves to
the blend's (16, L) entry features, and its backward
(`csrc/project.cu`).

The chain is the activations (exp of the log-scales, the quaternion's
normalisation, the opacity's sigmoid; or leaves already activated), the SH
colours (`utils/sh.py::eval_sh`, or colours given in their place), the EWA
projection (`projection.py::preprocess`) and the entry pack
(`blend.py::gather_entry_feats`). Plain PyTorch, it is ~420 small kernels a
render and ~800 in its autograd backward; here it is three:

- `project_fwd`: one thread a Gaussian; returns the (22, P) table (rows
  0:16 the entry features, 16 radius, 17:19 ext, 19:22 mean_c) and the
  valid mask, read as a `Preprocessed` by `preprocessed`. The geometry is
  bit-equal to the plain `preprocess` of the same activated inputs;
- `project_pack`: one thread an entry, the table's first 16 rows at each
  entry's Gaussian, opacity 0 on padding entries;
- `project_bwd`: one thread a Gaussian, the dfeats of its entries summed
  through the binning's `cell_entry` table (a segment sum, no atomics),
  then the chain rule to the leaves (`projection.py::project_bwd_ref`).

`ProjectFunction` is the pack as a differentiable function of the leaves;
`blend_inputs` is what `rasterize` runs for tensors on the card. Nothing
here waits for the card or falls back to the plain chain: a call that K4
does not take raises. `LAUNCHES` counts each kernel where its wrapper
launches it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import cuda_build
from .blend import NF
from .projection import Preprocessed, view_limits

TABLE_ROWS = 22
SH_ROWS = 16         # SH coefficient rows a Gaussian stores

LAUNCHES = dict.fromkeys(("project_fwd", "project_pack", "project_bwd"), 0)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: list = []


def _lib():
    if not _LIB:
        lib = ctypes.CDLL(str(cuda_build.build_libraries()["project"]))
        P, F, I, LL = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                       ctypes.c_longlong)
        cam = [P, P, P, P, F, F, F, F, I, I, I, I]
        lib.dqo_project_fwd.argtypes = [I, P, P, P, P, P, P] + cam + [P, P, P]
        lib.dqo_project_fwd.restype = I
        lib.dqo_project_pack.argtypes = [LL, I, P, P, P, P, P]
        lib.dqo_project_pack.restype = I
        lib.dqo_project_bwd.argtypes = ([I, I, LL, P, P, P, P, P, P, P] + cam
                                        + [P, P, P, P, P, P])
        lib.dqo_project_bwd.restype = I
        lib.dqo_cuda_error_string.argtypes = [I]
        lib.dqo_cuda_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


class Spec(NamedTuple):
    """K4's scalar arguments."""
    limx: float              # 1.3 x the half-FoV tangents, in float32
    limy: float
    color_sigma: float
    scale_modifier: float
    width: int
    height: int
    activate: bool           # the leaves as stored: exp, normalise, sigmoid
    sh_degree: int           # the colours are SH at this degree; -1: RGB


def make_spec(cam: dict, settings, colors: Optional[torch.Tensor],
              activate: bool) -> Spec:
    sh = colors is not None and colors.dim() == 3
    limx, limy = view_limits(cam)
    return Spec(
        limx=limx, limy=limy, color_sigma=float(settings.color_sigma),
        scale_modifier=float(settings.scale_modifier),
        width=int(settings.width), height=int(settings.height),
        activate=bool(activate),
        sh_degree=int(settings.sh_degree) if sh else -1)


def _check(what, x, shape, dtype, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must be {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{what} must be on {device}, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_leaves(means3d, scales, rots, opacities, colors, valid_mask,
                  spec: Spec):
    """What K4 reads per Gaussian: float32 (P, 3) means and scales, (P, 4)
    quaternions, (P,) opacities, colours (P, 3) or SH (P, 16, 3) at degree
    0-3, a bool (P,) mask; all contiguous on one card."""
    if means3d.dim() != 2:
        raise ValueError(f"means3d must be (P, 3), got "
                         f"{tuple(means3d.shape)}")
    P, dev = means3d.shape[0], means3d.device
    f32 = torch.float32
    _check("means3d", means3d, (P, 3), f32, dev)
    _check("scales", scales, (P, 3), f32, dev)
    _check("rots", rots, (P, 4), f32, dev)
    if opacities is not None:
        _check("opacities", opacities, (P,), f32, dev)
    if colors is not None:
        if spec.sh_degree >= 0:
            if not 0 <= spec.sh_degree <= 3:
                raise ValueError(f"K4 evaluates SH of degree 0-3, got "
                                 f"{spec.sh_degree}")
            _check("sh", colors, (P, SH_ROWS, 3), f32, dev)
        else:
            _check("colors", colors, (P, 3), f32, dev)
    if valid_mask is not None:
        _check("valid_mask", valid_mask, (P,), torch.bool, dev)
    if not means3d.is_cuda:
        raise ValueError("K4 runs on the card; the plain chain takes CPU "
                         "tensors")


def _cam_args(cam: dict, dev, sh: bool):
    """The camera as float32 tensors on the card, contiguous (the launch
    reads them by pointer), and their pointers."""
    ts = [cam[k].to(device=dev, dtype=torch.float32).contiguous()
          for k in ("w2c", "full_proj", "K")]
    for what, t, n in zip(("w2c", "full_proj", "K"), ts, (16, 16, 9)):
        if t.numel() != n:
            raise ValueError(f"cam['{what}'] must hold {n} values, got "
                             f"{t.numel()}")
    cp = (cam["cam_pos"].to(device=dev, dtype=torch.float32).contiguous()
          if sh else None)
    if cp is not None and cp.numel() != 3:
        raise ValueError("cam['cam_pos'] must hold 3 values")
    return ts + [cp]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _spec_args(spec: Spec):
    return (spec.limx, spec.limy, spec.color_sigma, spec.scale_modifier,
            spec.width, spec.height, int(spec.activate), spec.sh_degree)


def _raise_on(rc: int, lib, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} (K4) launch failed: "
                           + lib.dqo_cuda_error_string(rc).decode())


def project_fwd(means3d, scales, rots, opacities, colors, cam: dict,
                spec: Spec, valid_mask=None):
    """Launch K4's forward over every Gaussian row. `opacities` and
    `colors` may be None (the projection alone: their rows read 0).
    Returns (table (22, P) float32, valid (P,) bool)."""
    _check_leaves(means3d, scales, rots, opacities, colors, valid_mask, spec)
    P, dev = means3d.shape[0], means3d.device
    lib = _lib()
    # the kernel launches on the current device: make it the tensors' one
    with torch.cuda.device(dev):
        w2c, proj, K, cp = _cam_args(cam, dev, spec.sh_degree >= 0
                                     and colors is not None)
        table = torch.empty((TABLE_ROWS, P), dtype=torch.float32, device=dev)
        valid = torch.empty(P, dtype=torch.bool, device=dev)
        rc = lib.dqo_project_fwd(
            P, means3d.data_ptr(), scales.data_ptr(), rots.data_ptr(),
            _ptr(opacities), _ptr(colors), _ptr(valid_mask), w2c.data_ptr(),
            proj.data_ptr(), K.data_ptr(), _ptr(cp), *_spec_args(spec),
            table.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "project_fwd")
    LAUNCHES["project_fwd"] += 1
    return table, valid


def preprocessed(table: torch.Tensor, valid: torch.Tensor) -> Preprocessed:
    """The table as `Preprocessed` (views of its rows)."""
    return Preprocessed(
        valid=valid, xy=table[0:2].T, conic=table[2:5].T, depth=table[9],
        radius=table[16], mean_c=table[19:22].T, normal_c=table[10:13].T,
        scale_max=table[13], ext=table[17:19].T)


def project_pack(table: torch.Tensor, point_list: torch.Tensor,
                 entry_valid: torch.Tensor) -> torch.Tensor:
    """Launch K4's pack: feats (16, L), column e the table's first 16 rows
    at Gaussian `point_list[e]`, opacity 0 where `entry_valid` is not
    set."""
    dev = table.device
    if table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[0] != TABLE_ROWS or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous float32 "
                         f"({TABLE_ROWS}, P), got {table.dtype} "
                         f"{tuple(table.shape)}")
    if not table.is_cuda:
        raise ValueError("K4 runs on the card; the plain pack takes CPU "
                         "tensors")
    L = point_list.shape[0]
    _check("point_list", point_list, (L,), torch.int64, dev)
    _check("entry_valid", entry_valid, (L,), torch.bool, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        feats = torch.empty((NF, L), dtype=torch.float32, device=dev)
        rc = lib.dqo_project_pack(
            L, table.shape[1], table.data_ptr(), point_list.data_ptr(),
            entry_valid.data_ptr(), feats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "project_pack")
    LAUNCHES["project_pack"] += 1
    return feats


def project_bwd(dfeats, cell_entry, means3d, scales, rots, opacities, colors,
                cam: dict, spec: Spec, needs=(True,) * 5):
    """Launch K4's backward: dfeats (16, L) (rows 13 and 14 taken as 0) to
    the gradients of means3d, scales, rots, opacities and colors (None
    where `needs` says no, or where the input is None). `cell_entry` (R, P)
    int32 is the binning's entry of each enumerated cell, -1 for none."""
    _check_leaves(means3d, scales, rots, opacities, colors, None, spec)
    P, dev = means3d.shape[0], means3d.device
    if dfeats.dtype != torch.float32 or dfeats.dim() != 2 \
            or dfeats.shape[0] != NF:
        raise ValueError(f"dfeats must be float32 (16, L), got "
                         f"{dfeats.dtype} {tuple(dfeats.shape)}")
    L = dfeats.shape[1]
    _check("dfeats", dfeats, (NF, L), torch.float32, dev)
    if cell_entry.dim() != 2 or not 1 <= cell_entry.shape[0] < 32:
        raise ValueError(f"cell_entry must be (R, P) with 1 <= R < 32, got "
                         f"{tuple(cell_entry.shape)}")
    R = cell_entry.shape[0]
    _check("cell_entry", cell_entry, (R, P), torch.int32, dev)
    ins = (means3d, scales, rots, opacities, colors)
    outs = [torch.empty_like(x) if (x is not None and need) else None
            for x, need in zip(ins, needs)]
    lib = _lib()
    with torch.cuda.device(dev):
        w2c, proj, K, cp = _cam_args(cam, dev, spec.sh_degree >= 0
                                     and colors is not None)
        rc = lib.dqo_project_bwd(
            P, R, L, dfeats.data_ptr(), cell_entry.data_ptr(),
            means3d.data_ptr(), scales.data_ptr(), rots.data_ptr(),
            _ptr(opacities), _ptr(colors), w2c.data_ptr(), proj.data_ptr(),
            K.data_ptr(), _ptr(cp), *_spec_args(spec),
            *(_ptr(o) for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "project_bwd")
    LAUNCHES["project_bwd"] += 1
    return tuple(outs)


class ProjectFunction(torch.autograd.Function):
    """The entry pack as a differentiable function of the leaves: forward
    K4's pack of a table `project_fwd` made from the same leaves, backward
    K4's backward, which recomputes the chain per Gaussian."""

    @staticmethod
    def forward(ctx, table, point_list, entry_valid, cell_entry, means3d,
                scales, rots, opacities, colors, cam: dict, spec: Spec):
        ctx.save_for_backward(cell_entry, means3d, scales, rots, opacities,
                              colors)
        ctx.cam, ctx.spec = cam, spec
        return project_pack(table, point_list, entry_valid)

    @staticmethod
    def backward(ctx, dfeats):
        cell_entry, *leaves = ctx.saved_tensors
        grads = project_bwd(dfeats.contiguous(), cell_entry, *leaves,
                            ctx.cam, ctx.spec, ctx.needs_input_grad[4:9])
        return (None,) * 4 + grads + (None, None)


def blend_inputs(means3d, scales, rots, opacities, colors, cam: dict,
                 settings, valid_mask, activate: bool, bin_fn):
    """`rasterize.blend_inputs` on the card: K4's forward, the binning
    (`bin_fn(pre)`, a given binning or a new one), and K4's pack, through
    `ProjectFunction` where a gradient is wanted. Returns (Preprocessed,
    Binning, feats (16, L))."""
    leaves = [x.contiguous() for x in (means3d, scales, rots, opacities,
                                       colors)]
    spec = make_spec(cam, settings, colors, activate)
    with torch.no_grad():
        table, valid = project_fwd(*leaves, cam, spec, valid_mask)
    pre = preprocessed(table, valid)
    b = bin_fn(pre)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        feats = ProjectFunction.apply(table, b.point_list, b.entry_valid,
                                      b.cell_entry, *leaves, cam, spec)
    else:
        feats = project_pack(table, b.point_list, b.entry_valid)
    return pre, b, feats
