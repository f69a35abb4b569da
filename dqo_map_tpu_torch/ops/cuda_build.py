"""The build of the port's hand-written CUDA kernels: K1 and K2, the
blend's forward and backward (`csrc/blend_fwd.cu`, `csrc/blend_bwd.cu`,
bound in `blend_cuda.py`), K3, densification's KNN (`csrc/knn.cu`, bound
in `knn.py`), and K4, the render's per-Gaussian chain (`csrc/project.cu`,
bound in `project_cuda.py`).

Each source of `SOURCES` is built with `nvcc` for `sm_90a` at first use,
one nvcc per source, all started together, into `dqo_map_tpu_torch/_build/`
under a name keyed by the hash of the source and the flags.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
SOURCES = {"blend_fwd": PKG / "csrc" / "blend_fwd.cu",
           "blend_bwd": PKG / "csrc" / "blend_bwd.cu",
           "knn": PKG / "csrc" / "knn.cu",
           "project": PKG / "csrc" / "project.cu"}
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "for sm_90a at first use and need the CUDA toolkit")
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
