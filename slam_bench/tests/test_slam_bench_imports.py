"""What the benchmark loads: the run's check for JAX and the JAX package
by whole top-level name, and a reference that imports nothing of the
port."""

import subprocess
import sys
from pathlib import Path

from slam_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_by_whole_top_level_name(monkeypatch):
    for name in ("dqo_map_tpu_torch", "dqo_map_tpu_torch.slam",
                 "jaxtyping", "jax_helpers_x"):
        monkeypatch.setitem(sys.modules, name, object())
    before = harness.forbidden_modules()
    assert "dqo_map_tpu_torch" not in before and "jaxtyping" not in before
    for name in ("jax.numpy", "dqo_map_tpu.ops", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
    found = harness.forbidden_modules()
    assert {"jax", "dqo_map_tpu", "jaxlib"} <= set(found)
    assert "dqo_map_tpu_torch" not in found


def test_reference_imports_nothing_of_the_port():
    code = (
        "import sys\n"
        "import slam_bench.reference.blend_fn, slam_bench.reference.scan\n"
        "import slam_bench.reference.objects, slam_bench.reference.frame\n"
        "import slam_bench.reference.icp, slam_bench.reference.renderer\n"
        "import slam_bench.check, slam_bench.roofline, slam_bench.stats\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('dqo_map_tpu_torch', 'dqo_map_tpu', 'jax', 'jaxlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_reference_sources_name_no_port_module():
    for p in (ROOT / "slam_bench" / "reference").glob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "dqo_map_tpu" not in s and "jax" not in s, (p, s)


def test_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    cannot make a result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload", "office0-explore",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
