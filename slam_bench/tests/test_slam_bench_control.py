"""The control: the reference computed in the precision below the
configuration's (bfloat16 for float32) fails the limits, in every cell,
at a size the CPU holds (the chip's readings at the cells' own size are
in PERF.md, from `slam_bench/control.py`)."""

import pytest
import torch

from slam_bench import check
from slam_bench.control import readings
from slam_bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("cell", ["office0-explore", "fr1_desk-handheld"])
def test_control_fails_and_program_passes(cell):
    torch.set_num_threads(4)
    c = tiny_cell(cell)
    limits = c["traffic"]["check"]["limits"]
    for r in readings(c, [5, 2**32 + 3], "cpu"):
        ok, rows = check.verdict(r["program"], limits)
        assert ok, rows
        ok, rows = check.verdict(r["control"], limits)
        assert not ok, rows
