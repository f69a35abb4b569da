"""The optimize scans' steps as CUDA graphs (`slam/mapper.py`:
`capture_plan`, `ScanGrads`, `GradsGraph`).

On the CPU:
- the capture plan is a pure function of the schedule: a frame drawn once
  runs eagerly, a frame drawn more often is captured at its first draw and
  replayed at each later one, whatever the schedule (all steps on one
  frame, every frame once, the local and keyframe scans' pinned
  schedules);
- on CPU tensors `compact_optimize_scan` runs every step eagerly: it calls
  `adam_update` once a step, each with the step's real parameters (the
  previous call's output), and its report counts `eager_steps == iters`
  and no capture or replay.

On a card (marker `cuda`): the scans that a short run of `SLAMSystem.step`
on synthetic frames makes (the local scan with its one-surface
background, the keyframe scan without), and the local scan again with a
semantic image, are each run twice from the same inputs: graphed, and with
every step eager (the plan monkeypatched here). Held: the counters to the
plan; the loss curves step by step (relative gap at most 1e-4, the
benchmark check's `scan_loss_gap` limit); the first three `adam_update`
calls, seen through a wrapper as the benchmark's check sees them, with
the first gradient (from the first moment) within 2e-4 and the change
after three steps within 5e-2 by the check's worst-leaf norm gap (its
`scan_grad_gap` and `scan_change_gap` limits: only the order of K2's and
`index_add_`'s atomics differs); each call's parameters the previous
call's output; the parameters after all steps by the same change gap, and
the confidence exactly.

This file imports neither JAX nor the JAX package; on the card, run it
without the JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_scan_graph.py -q

The card's tests need a CUDA card and skip without one.
"""

import gc
import inspect
import statistics
import weakref

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.slam import mapper

E, C, R = mapper.EAGER, mapper.CAPTURE, mapper.REPLAY
SCAN_STEPS = 3
LOSS_GAP, GRAD_GAP, CHANGE_GAP = 1e-4, 2e-4, 5e-2


def _pinned(iters, n_frames, seed):
    """A scan's schedule as `Mapping._rand_schedule` draws it."""
    idx = np.random.default_rng(seed).integers(0, n_frames, size=iters)
    idx[iters // 2 + 1:] = n_frames - 1
    return idx.astype(np.int32)


PLANS = {
    "one_frame": ([0] * 6, [C] + [R] * 5),
    "each_frame_once": ([3, 1, 0, 4, 2], [E] * 5),
    "twice_each": ([0, 1, 0, 1], [C, C, R, R]),
    "mixed": ([2, 0, 2, 1, 4, 4, 2], [C, E, R, E, C, R, R]),
    "empty": ([], []),
}
SCHEDULES = {"local_50_over_5": (50, 5), "keyframe_50_over_3": (50, 3),
             "fr1_desk_60_over_5": (60, 5), "first_scan_50_over_1": (50, 1)}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_capture_plan_cases(name):
    rand_idx, want = PLANS[name]
    assert mapper.capture_plan(rand_idx) == want
    assert mapper.capture_plan(np.asarray(rand_idx, np.int32)) == want


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_capture_plan_is_a_function_of_the_schedule(name, seed):
    iters, n_frames = SCHEDULES[name]
    idx = _pinned(iters, n_frames, seed)
    plan = mapper.capture_plan(idx)
    assert plan == mapper.capture_plan(idx.tolist()) == mapper.capture_plan(
        idx.copy())
    frames = idx.tolist()
    for it, (f, step) in enumerate(zip(frames, plan)):
        if frames.count(f) == 1:
            assert step == E, it
        else:
            assert step == (C if frames.index(f) == it else R), it
    drawn_again = {f for f in frames if frames.count(f) > 1}
    assert plan.count(C) == len(drawn_again)
    # the newest frame holds the pinned second half: every one a replay
    assert set(plan[iters // 2 + 2:]) == {R}


# ---------------------------------------------------------------------------
# scans recorded from a short run
# ---------------------------------------------------------------------------

RUN = dict(
    type="Synthetic", use_gt_pose=False, use_orb_backend=False,
    use_object=False, capacity=16384, add_capacity=4096,
    uniform_sample_num=1000, gaussian_update_frame=2,
    stable_confidence_thres=2, global_keyframe_num=3, min_depth=0.1,
    max_depth=8.0, memory_length=5, keyframe_theta_thes=1.0,
    keyframe_trans_thes=10.0, sync_tracker2mapper_method="strict")


def _clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, mapper.MapState):
        return x.replace(**{f: getattr(x, f).clone()
                            for f in mapper.gm.FIELDS})
    return x


def _record_scans(device, tmp_path, frames, width, height, iters):
    """{"local": the last local scan's arguments, "keyframe": the first
    keyframe scan's}, as `compact_optimize_scan` was called in a run of
    `frames` frames."""
    from dqo_map_tpu_torch.config import default_config
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    _, cams = synthetic_sequence(frames, width=width, height=height)
    system = SLAMSystem(default_config(save_path=str(tmp_path),
                                       gaussian_update_iter=iters, **RUN),
                        cameras=cams, device=device)
    scan = mapper.compact_optimize_scan
    calls = {}

    def recording(*a, **kw):
        b = inspect.signature(scan).bind(*a, **kw)
        b.apply_defaults()
        kind = "local" if b.arguments["use_bg"] else "keyframe"
        if kind == "local" or kind not in calls:
            calls[kind] = _clone(dict(b.arguments))
        return scan(*a, **kw)

    mapper.compact_optimize_scan = recording
    try:
        for i, cam in enumerate(cams):
            system.step(cam, i)
            system.mapping.time += 1
    finally:
        mapper.compact_optimize_scan = scan
    assert set(calls) == {"local", "keyframe"}, sorted(calls)
    return calls


def _scan(args, monkeypatch, eager: bool):
    """`compact_optimize_scan` from a copy of `args`, every step eager or
    as the plan says. Returns (state, report, the first `SCAN_STEPS`
    `adam_update` calls' p_in / p_out / m, the number of calls, whether
    each call's params were the previous call's output)."""
    adam = mapper.adam_update
    seen, chained, last = [], [], [None]

    def recording(params, grads, st, lrs, mask, **kw):
        new_p, new_st = adam(params, grads, st, lrs, mask, **kw)
        chained.append(last[0] is None or all(
            params[k] is last[0][k] for k in params))
        last[0] = new_p
        if len(seen) < SCAN_STEPS:
            seen.append({"p_in": _clone(params), "p_out": _clone(new_p),
                         "m": _clone(new_st.m)})
        return new_p, new_st

    with monkeypatch.context() as m:
        m.setattr(mapper, "adam_update", recording)
        if eager:
            m.setattr(mapper, "capture_plan",
                      lambda idx: [mapper.EAGER] * len(idx))
        state, rep = mapper.compact_optimize_scan(**_clone(args))
    return state, rep, seen, len(chained), all(chained)


@pytest.fixture(scope="module")
def cpu_scans(tmp_path_factory):
    return _record_scans("cpu", tmp_path_factory.mktemp("cpu"), 4, 64, 48, 3)


@pytest.mark.parametrize("kind", ["local", "keyframe"])
def test_cpu_scan_steps_are_eager_with_real_params(cpu_scans, kind,
                                                   monkeypatch):
    args = cpu_scans[kind]
    iters = args["iters"]
    _, rep, seen, calls, chained = _scan(args, monkeypatch, eager=False)
    assert calls == iters and chained
    assert rep["eager_steps"] == iters
    assert rep["graph_captures"] == rep["graph_replays"] == 0
    assert rep["replayed_blends"] == 0
    # the first step starts from the scan's rows as gathered from the map
    rows = torch.nonzero(args["row_mask"])[:, 0]
    for k, v in seen[0]["p_in"].items():
        assert torch.equal(v, getattr(args["state"], k)[rows]), k
    for a, b in zip(seen, seen[1:]):
        for k in a["p_out"]:
            assert torch.equal(b["p_in"][k], a["p_out"][k]), k


# ---------------------------------------------------------------------------
# on a card: graphed against eager
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_scans(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs are the card's")
    return _record_scans(torch.device("cuda"),
                         tmp_path_factory.mktemp("card"), 4, 160, 120, 12)


class _Cycle:
    """Garbage that only the collector frees: a reference cycle holding
    pinned host memory copied into from the card, an event and a
    captured CUDA graph (as a dropped system's ICP graph would be)."""

    def __init__(self, graph):
        self.me = self
        dev = torch.ones(1 << 16, device="cuda")
        self.host = torch.empty(1 << 16, pin_memory=True)
        self.host.copy_(dev, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        self.graph = graph


def _tiny_graph():
    x = torch.zeros(4, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.add_(1)
    return g


@pytest.mark.cuda
def test_card_capture_survives_collectable_garbage(card_scans, monkeypatch):
    """Each `_grads` (the captured ones inside their capture) first leaves
    cyclic garbage that holds pinned memory, an event and a CUDA graph,
    with the collector set to run at every allocation. None of it is
    collected inside a capture, and every capture holds."""
    args = _clone(card_scans["local"])
    graphs = [_tiny_graph() for _ in range(args["iters"])]
    grads = mapper._grads
    collected = []             # capturing or not, as each cycle went

    def littering(*a, **kw):
        weakref.finalize(_Cycle(graphs.pop()), lambda: collected.append(
            torch.cuda.is_current_stream_capturing()))
        return grads(*a, **kw)

    threshold = gc.get_threshold()
    monkeypatch.setattr(mapper, "_grads", littering)
    gc.set_threshold(1)
    try:
        _, rep = mapper.compact_optimize_scan(**args)
        torch.cuda.synchronize()
        gc.collect()
    finally:
        gc.set_threshold(*threshold)
    assert gc.isenabled()
    steps = rep["eager_steps"] + rep["graph_captures"]
    assert rep["graph_captures"] >= 1 and len(collected) == steps
    assert not any(collected)
    assert rep["graph_replays"] == args["iters"] - rep["eager_steps"]
    assert torch.isfinite(rep["total_loss"]).all()


def _leaf_gap(prog: dict, ref: dict) -> float:
    """The benchmark check's worst-leaf gap: between the norms of the two
    runs' tensors, over the larger of the leaf's norm and the median
    leaf's, over the leaves the eager run moves."""
    def norm(v):
        return float(torch.linalg.vector_norm(v.double()))

    rn = {k: norm(v) for k, v in ref.items()}
    pn = {k: norm(v) for k, v in prog.items()}
    med = statistics.median(rn.values())
    keep = [k for k in rn if rn[k] >= 1e-3 * med]
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep)


def _change(p_out, p_in):
    return {k: p_out[k] - p_in[k] for k in p_in}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["local_bg", "keyframe", "local_semantics"])
def test_card_graphed_scan_matches_eager(card_scans, case, monkeypatch):
    args = _clone(card_scans["keyframe" if case == "keyframe" else "local"])
    if case == "local_semantics":
        color = args["frames"]["color"]
        args["frames"]["semantics_color"] = color.flip(-1).contiguous()
    iters = args["iters"]
    plan = mapper.capture_plan(args["rand_idx"])
    assert mapper.CAPTURE in plan and mapper.REPLAY in plan
    gs, grep, gseen, gcalls, gchained = _scan(args, monkeypatch, eager=False)
    es, erep, eseen, ecalls, echained = _scan(args, monkeypatch, eager=True)
    torch.cuda.synchronize()

    # the counters follow the plan
    assert gcalls == ecalls == iters and gchained and echained
    assert grep["graph_captures"] == plan.count(mapper.CAPTURE)
    assert grep["graph_replays"] == iters - grep["eager_steps"]
    assert grep["eager_steps"] == plan.count(mapper.EAGER)
    assert erep["eager_steps"] == iters and erep["graph_replays"] == 0
    assert grep["iters"] == erep["iters"] == iters
    sem = 2 if case == "local_semantics" else 1
    assert grep["replayed_blends"] == sem * plan.count(mapper.REPLAY)

    # the loss curves, step by step
    g = (grep["total_loss"] + grep["scale_loss"]).double()
    e = (erep["total_loss"] + erep["scale_loss"]).double()
    gap = ((g - e).abs() / e.abs().clamp(min=1e-30)).max()
    assert float(gap) <= LOSS_GAP, (g.tolist(), e.tolist())

    # the first Adam steps as the benchmark's check sees them
    for k in gseen[0]["p_in"]:
        assert torch.equal(gseen[0]["p_in"][k], eseen[0]["p_in"][k]), k
    for seen in (gseen, eseen):
        for a, b in zip(seen, seen[1:]):
            for k in a["p_out"]:
                assert torch.equal(b["p_in"][k], a["p_out"][k]), k
    assert _leaf_gap(gseen[0]["m"], eseen[0]["m"]) <= GRAD_GAP
    p0 = eseen[0]["p_in"]
    assert _leaf_gap(_change(gseen[-1]["p_out"], p0),
                     _change(eseen[-1]["p_out"], p0)) <= CHANGE_GAP

    # the map after every step
    rows = torch.nonzero(args["row_mask"])[:, 0]
    assert torch.equal(gs.confidence, es.confidence)
    after_g = {k: getattr(gs, k)[rows] for k in mapper.OPT_FIELDS}
    after_e = {k: getattr(es, k)[rows] for k in mapper.OPT_FIELDS}
    assert _leaf_gap(_change(after_g, p0), _change(after_e, p0)) <= CHANGE_GAP
    untouched = torch.ones_like(args["row_mask"])
    untouched[rows] = False
    for k in mapper.OPT_FIELDS:
        assert torch.equal(getattr(gs, k)[untouched],
                           getattr(args["state"], k)[untouched]), k
