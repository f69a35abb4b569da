"""DQO-MAP in PyTorch and CUDA for NVIDIA Hopper (H100).

The second implementation of the `dqo_map_tpu` system, beside the JAX one,
which stays the reference. The layout mirrors `dqo_map_tpu/` module for
module (`ops/ models/ slam/ utils/ data/`); the hand-written CUDA kernels
live in `csrc/`. Nothing here imports JAX or the JAX package: JAX-free
modules of that package are kept as copies (`config.py`,
`data/synthetic.py`, the host half of `models/cameras.py`).

Ported so far is the per-frame forward path of `SLAMSystem.step`:
preprocessing, multi-scale ICP tracking, densification, the model renders
(through the forward blend kernel `csrc/blend_fwd.cu`) and the
promote / error-remove / delete tail. The optimize scans and the backward
blend come next.

Every entry point takes a `device` and defaults to CUDA; the CPU runs only
when `device="cpu"` is asked for, and then the kernels' plain PyTorch
versions run in their place.
"""

__version__ = "0.1.0"
