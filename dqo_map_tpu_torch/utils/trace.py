"""The port's span recorder: one name for each layer's work, from the frame
down to the optimize scans' Adam steps and the host's waits on the card.

A span is a `with span(name, ...)` block around the work it names; names
are paths (`scans/step/backward`), a frame's spans nest in its
`system/step#<frame id>` span (`frame`), and a span around one blocking
read of the card (a device-to-host read, or an upload that waits for it)
ends in `/wait`, one read a span. A layer's own reads carry its path
(`mapping/counts/wait`); an op's carry the op's name alone
(`bin_gaussians/wait`), whoever calls it, and nest in the caller's span.
The recorder is in one of three states:

- off (the default): a span is one flag test; it reads no clock, records
  nothing and makes no call into `torch.profiler`.
- on (`enable`): each named span is a `torch.profiler.record_function`, so
  a profiler's trace holds it on the same clock as the card's kernels,
  inside the span open around it. Nothing waits for the card.
- staged (`profile_enable`, or `DQO_PROFILE` set at import): the stage
  timers. A span with a `tag` (the JAX package's stage tags) waits for the
  card at its end (unless `wait_end=False`) and records its ms since its
  start under the tag (`stage_times`); a `staged` span waits for the card
  at its start and its end and records its ms and its counters under its
  name (`span_readings`): `steps` where given, and what `count` adds
  while it is open (the scans' steps and `graph_captures`,
  `graph_replays`, `eager_steps`). Every other span, the per-step and
  wait spans among them, records nothing and never waits. With the card
  waited for, the host no longer runs ahead of it: staged times give the
  split of a frame, not its time.
"""

from __future__ import annotations

import os
import time

import torch

OFF, ON, STAGED = "off", "on", "staged"

_mode = STAGED if os.environ.get("DQO_PROFILE") else OFF
_stages: dict = {}          # JAX tag -> [ms], staged
_readings: dict = {}        # staged span name -> [{"ms": .., counters}]
_open: list = []            # the staged spans open now, outermost first


class _Null:
    """The span of the off state, and of a span with nothing to do."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _sync():
    """Wait for every card this process has used (none on the CPU)."""
    if torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


class _Span:
    __slots__ = ("name", "tag", "staged", "wait_end", "counters", "t0", "rf")

    def __init__(self, name, tag, staged, wait_end, steps):
        self.name, self.tag, self.staged = name, tag, staged
        self.wait_end = wait_end
        self.counters = {} if steps is None else {"steps": steps}
        self.rf = self.t0 = None

    def __enter__(self):
        if _mode == ON:
            if self.name is not None:
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
        else:
            if self.staged:
                _sync()
                _open.append(self)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
            return False
        if self in _open:
            _open.remove(self)
        if _mode == STAGED and self.t0 is not None:
            if self.staged or self.wait_end:
                _sync()
            ms = (time.perf_counter() - self.t0) * 1000
            if self.tag is not None:
                _stages.setdefault(self.tag, []).append(ms)
            if self.staged:
                _readings.setdefault(self.name, []).append(
                    {"ms": ms, **self.counters})
        return False


def span(name=None, tag=None, staged=False, wait_end=True, steps=None):
    """The span `name` (None: a stage tag alone, no span when on). `tag`:
    the JAX stage tag it records under when staged, after waiting for the
    card unless `wait_end` is False; `staged`: a staged reading of its own,
    with `steps` as its first counter (`count` adds more)."""
    if _mode == OFF:
        return _NULL
    if _mode == STAGED and tag is None and not staged:
        return _NULL
    return _Span(name, tag, staged, wait_end, steps)


def count(**counters):
    """Add `counters` (name: number) to the reading of every staged span
    open now; nothing unless staged."""
    for s in _open:
        for k, v in counters.items():
            s.counters[k] = s.counters.get(k, 0) + v


def frame(frame_id: int):
    """The span of one frame, `system/step#<frame_id>`, when on."""
    if _mode != ON:
        return _NULL
    return _Span(f"system/step#{frame_id}", None, False, False, None)


def enable(flag: bool = True):
    """Switch the spans on (a `record_function` each) or off."""
    global _mode
    _mode = ON if flag else OFF


def profile_enable(flag: bool = True):
    """Switch the stage timers on (the staged state) or off
    (`DQO_PROFILE` sets the start)."""
    global _mode
    _mode = STAGED if flag else OFF


def stage_times(reset: bool = False) -> dict:
    """{JAX tag: [ms, ...]} recorded while staged since the last reset."""
    global _stages
    out = {k: list(v) for k, v in _stages.items()}
    if reset:
        _stages = {}
    return out


def span_readings(reset: bool = False) -> dict:
    """{staged span name: [{"ms": .., counter: .., ...}, ...]} recorded
    while staged since the last reset (the counters where the span has
    them)."""
    global _readings
    out = {k: [dict(r) for r in v] for k, v in _readings.items()}
    if reset:
        _readings = {}
    return out

