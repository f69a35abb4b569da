"""A cell on the card, through the command the driver runs, for a window
that reaches the cell's quality frame (23: ~20 s at fr1_desk-handheld's
~1.2 fps). Skips where there is no card (decided inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card only")
    r = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload", "fr1_desk-handheld",
         "--seed", str(2**31 + 7), "--seconds", "30", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    assert {"setup_s", "fps", "psnr_db"} <= set(res["metrics"])
