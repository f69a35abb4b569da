"""The benchmark of the PyTorch / CUDA port, one run of one cell:

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object: correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and the numbers compared beside their limits under `check`),
and those numbers as the last lines of standard error. Exits 2 without a
result where there is no card or too few, 3 where the run loaded JAX or
the JAX package. See `slam_bench/harness.py`.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from slam_bench.harness import main
    sys.exit(main(t_start=T_START))
