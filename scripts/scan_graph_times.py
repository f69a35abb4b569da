"""The optimize scans' graphs on the card, over one short benchmark run of a
cell: each capture's host time, each replay's device time (CUDA events
around `GradsGraph.__call__`), and the kernels of the first replays and of
the first eager `_grads` steps (the profiler's count of CUDA events:
kernels, memsets and copies; the profiled replays are left out of the
times). The run's first scan takes every step eagerly, as a scan does
where each frame is drawn once, so that eager steps are there to count.

    python3 scripts/scan_graph_times.py <cell> <seed> [seconds]

Run it from the root of a checkout of the port; it prints one line. It
reads the program as it stands, so a checkout of an older commit can be
measured by running this file from that checkout's root.
"""

import statistics
import sys
import time
from pathlib import Path

# the checkout in place of this file's folder, whose `profile.py` would
# shadow the standard library's, which the profiler imports
sys.path[0] = str(Path.cwd())

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dqo_map_tpu_torch.slam import mapper  # noqa: E402
from slam_bench import harness  # noqa: E402

PROFILED = 3       # replays and eager steps counted by the profiler


def main(cell: str, seed: int, seconds: float) -> None:
    captures, replays, replay_kernels, eager = [], [], [], []
    init, call = mapper.GradsGraph.__init__, mapper.GradsGraph.__call__
    grads, plan = mapper._grads, mapper.capture_plan

    def timed_init(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        init(self, *a, **kw)
        torch.cuda.synchronize()
        captures.append(1e3 * (time.perf_counter() - t0))

    def cuda_events(fn, *a, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        return out, sum(1 for ev in prof.events()
                        if ev.device_type.name == "CUDA")

    def timed_call(self, *a, **kw):
        if len(replay_kernels) < PROFILED:
            out, n = cuda_events(call, self, *a, **kw)
            replay_kernels.append(n)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(self, *a, **kw)
        end.record()
        replays.append((start, end))
        return out

    def counted_grads(*a, **kw):
        if torch.cuda.is_current_stream_capturing() \
                or len(eager) >= PROFILED:
            return grads(*a, **kw)
        out, n = cuda_events(grads, *a, **kw)
        eager.append(n)
        return out

    def first_scan_eager(rand_idx):
        mapper.capture_plan = plan
        return [mapper.EAGER] * len(rand_idx)

    mapper.capture_plan = first_scan_eager
    mapper.GradsGraph.__init__ = timed_init
    mapper.GradsGraph.__call__ = timed_call
    mapper._grads = counted_grads
    harness.fixed_cache_dirs()
    res, _ = harness.run(harness.load_cell(cell), seed, seconds, False,
                         time.perf_counter())
    torch.cuda.synchronize()
    replay_ms = [s.elapsed_time(e) for s, e in replays]

    def quartiles(x):
        return ([round(v, 3) for v in statistics.quantiles(x, n=4)]
                if len(x) > 1 else x)

    print(f"{cell}: correct {res['correct']}; captures {len(captures)}, "
          f"host ms quartiles {quartiles(captures)}; replays "
          f"{len(replay_ms)}, device ms quartiles {quartiles(replay_ms)}; "
          f"kernels of the first replays {replay_kernels}, of the first "
          f"eager steps {eager}; "
          f"{torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]),
         float(sys.argv[3]) if len(sys.argv) > 3 else 20.0)
