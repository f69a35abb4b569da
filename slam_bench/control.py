"""The readings the limits of `correct` are set from, for one cell, at the
cell's own size, in one process:

    python3 slam_bench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed it makes the cell's frames, drives a fresh system through
`SLAMSystem.step` from frame 0 to the quality frame Q, as a run's window
does, and compares what it
recorded twice: with the plain reference in the configuration's precision
(the program's reading, the lower one), and with the reference computed
in the control's lower precision (`check.compare(control=True)`, bfloat16
at every stage's boundary). Since the program agrees with the float32
reference to within the lower reading, the second is the control's
reading, the gap between the reference in bfloat16 and in float32, to
within that lower reading: the upper one.
Prints one JSON line a seed; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell: dict, seeds, device):
    """One dict a seed: the program's numbers and the control's."""
    import numpy as np
    import torch
    from dqo_map_tpu_torch.models.cameras import Camera

    from slam_bench import check, harness
    from slam_bench.frames import FramePool
    traffic, config = cell["traffic"], cell["config"]
    device = torch.device(device)
    q = int(traffic["quality_frame"])
    chk = traffic["check"]
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        pool = FramePool(config["camera"], traffic, seed, device)
        if k == 0:
            harness.warm_up(config, traffic, pool, device)
        rng = np.random.default_rng(seed)
        tracks = sorted(rng.choice(np.arange(1, q + 1),
                                   size=min(int(chk["track_frames"]), q),
                                   replace=False).tolist())
        rec = check.Recorder(q, tracks, "objects" in chk["layers"],
                             chk["seams"])
        system = harness.make_system(config, pool, device)
        rec.install(system)
        try:
            for i in range(q + 1):
                rec.frame = i
                system.step(pool.camera(i, Camera), i)
                system.mapping.time += 1
        finally:
            rec.uninstall()
        if system.object_layer is not None:
            rec.n_objects = len(system.object_layer.objects)
        system = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        prog = check.compare(rec, chk["layers"], config["config"], pool,
                             device)
        ctrl = check.compare(rec, chk["layers"], config["config"], pool,
                             device, control=True)
        yield {"workload": cell["name"], "seed": seed, "program": prog,
               "control": ctrl, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    from slam_bench import harness
    harness.fixed_cache_dirs()
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(cell, seeds, "cuda"):
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
