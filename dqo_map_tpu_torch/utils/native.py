"""Builds the port's native host libraries from the C++ sources under
`runtime/` with `g++`, into `dqo_map_tpu_torch/_build/`, each under a name
keyed by the hash of its source and its command's flags. `runtime/` is
only read; a missing compiler or a failed build raises with the compiler's
output."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path


def build_shared(source: Path, build_dir: Path, stem: str, flags: list,
                 libs: list, what: str) -> Path:
    """`g++ <flags> -o <build_dir>/<stem>_<hash>.so <source> <libs>` unless
    that library is already there; returns its path. `what` names the
    library in the errors."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags + libs).encode()).hexdigest()[:12]
    target = build_dir / f"{stem}_{tag}.so"
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: {what} is built from "
                           f"{source} at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [cxx, *flags, "-o", tmp, str(source), *libs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    return target
