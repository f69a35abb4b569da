"""The precision of the plain reference.

By default the reference computes in float32, the configurations' stated
precision. The lower-precision control (`lowered`) rounds every tensor to
bfloat16 where one stage hands it to the next: the inputs, the blend's
entry features, its output blocks and cotangents, the scans' gradients,
and ICP's normal equations. Arithmetic inside a stage stays in float32,
as on a path that stores its intermediates in bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

_STATE = {"dtype": None}


def rnd(x):
    """`x` rounded to the control's precision and back, under `lowered`;
    `x` itself otherwise, and for a tensor that is not floating point."""
    dt = _STATE["dtype"]
    if dt is None or not torch.is_tensor(x) or not x.is_floating_point():
        return x
    return x.to(dt).to(x.dtype)


@contextlib.contextmanager
def lowered(dtype=torch.bfloat16):
    """Within the block, `rnd` rounds to `dtype`."""
    old = _STATE["dtype"]
    _STATE["dtype"] = dtype
    try:
        yield
    finally:
        _STATE["dtype"] = old
