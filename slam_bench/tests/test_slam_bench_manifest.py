"""`BENCHMARK.json` against the benchmark's contract, and every file a
cell is found by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_sizes():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    all_names = [m["name"] for m in metrics]
    assert len(set(all_names)) == len(all_names)
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    assert "setup_s" in all_names
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    from slam_bench.harness import BENCH as DIR, load_cell
    c = load_cell(cell)
    assert (DIR / "paths" / f"{c['traffic']['path']['kind']}.py").is_file()
    reported = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in reported and len(reported) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert (DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in c["per_layer"]:
        assert m["moves"] in reported
    chk = c["traffic"]["check"]
    assert chk["limits"] and set(chk["layers"]) <= {"render", "scan",
                                                    "track", "objects"}
    q = c["traffic"]["quality_frame"]
    assert (q + 1) % c["config"]["config"]["gaussian_update_frame"] == 0
    seams = chk["seams"]
    assert {"render", "scan", "adam", "icp"} <= set(seams)
    assert ("objects" in seams) == ("objects" in chk["layers"])
    t = c["traffic"]
    # a pass reaches Q, and the traced stretches, which go on from where
    # the window ended, stay inside the pool (no jump back to frame 0)
    assert q < t["window"]["pass_frames"]
    assert t["pool_frames"] >= (t["window"]["pass_frames"]
                                + t["trace"]["profiled_frames"]
                                + t["trace"]["max_timed_frames"])
