"""The port's own spans and counters (``utils/profiling.py``).

- The gate: spans and counters record exactly while a ``torch.profiler``
  records (torch's ``_profiler_enabled`` flag); with none, nothing is
  recorded, and the instrumented engines give bit-identical outputs either
  way.
- Spans: nesting, self time, stamps on the profiler's clock, and the
  exported Chrome trace.
- Counters: the KLT, LM and BA loops' trips against the iteration counts
  their results report, and each ``sync.*`` read counter against them.
- ``attribute``: idle gaps and launches laid on the innermost span.
- The benchmark's nine readers of the recorder (``vobench/metrics/``).
"""

import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.models import frontend as fe
from uasl_motion_estimation_tpu_torch.models import smoother as sm
from uasl_motion_estimation_tpu_torch.models.pipeline import (
    OdometryPipeline, default_config, make_sampler)
from uasl_motion_estimation_tpu_torch.ops import image as im
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.solvers import ba as tba
from uasl_motion_estimation_tpu_torch.solvers import lm as tlm
from uasl_motion_estimation_tpu_torch.utils import profiling, synthetic
from uasl_motion_estimation_tpu_torch.utils.profiling import SpanRecord

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=160.0, fv=160.0, cu=80.0, cv=48.0, baseline=0.54, height=96,
                          width=160)
CFG = default_config(Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv), RIG.baseline)._replace(
    max_features=64)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def staged():
    seq = synthetic.SyntheticStereoSequence(n_frames=9, rig=RIG, seed=0)
    return OdometryPipeline(CFG, seed=0, device="cpu").stage_frames(
        [seq.frame(i) for i in range(9)])


@pytest.fixture
def rec():
    r = profiling.recorder()
    r.clear()
    yield r
    r.clear()


def recorded(fn):
    """fn() under a CPU profile, with the recorder cleared first."""
    profiling.recorder().clear()
    with torch.profiler.profile(activities=CPU):
        return fn()


def test_the_gate_is_torchs_profiler_flag():
    flag = torch._C._autograd._profiler_enabled  # fails here if torch renames it
    assert profiling._profiling is flag
    assert not flag()
    with torch.profiler.profile(activities=CPU):
        assert flag()
    assert not flag()


def test_nothing_is_recorded_without_a_profiler(rec):
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    with profiling.span("a"):
        profiling.count("n", 3)
    assert rec.spans == [] and dict(rec.counters) == {}


def _staged(ls_rs):
    pipe = OdometryPipeline(CFG, seed=0, device="cpu")
    return [pipe.run_staged(*ls_rs, chunk=4)]


def _unified(ls_rs):
    out = sm.unified_system_scan(*ls_rs, make_sampler(1, CFG.vo.n_ransac),
                                 sm.SmootherConfig(pipe=CFG), wchunk=2)
    return list(out) + list(sm.compose_unified(out, 9, sm.SmootherConfig(pipe=CFG)))


def ba_batch():
    """Three windows started ever farther from their optimum, so they take
    2, 4 and 11 iterations."""
    intr = Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv)
    wins = []
    for s, scale in zip((3, 4, 5), (0.0, 0.05, 0.2), strict=True):
        cams, pts, obs, mask = synthetic.ba_window(intr, RIG.baseline, n_frames=5, n_pts=40,
                                                   noise=0.3, seed=s, image_shape=(96, 160))
        wins.append((*synthetic.perturb_ba_window(cams, pts, cam_scale=scale,
                                                  pt_scale=10 * scale, seed=s + 100), obs, mask))
    return tba.BAProblem(*(torch.from_numpy(np.stack(x)) for x in zip(*wins))), tba.BAConfig(
        intr=intr, baseline=RIG.baseline, n_fixed=2)


def _ba(_):
    return list(tba.ba_solve(*ba_batch()))


@pytest.mark.parametrize("run", [_staged, _unified, _ba], ids=["run_staged",
                                                              "unified_system_scan", "ba_solve"])
def test_outputs_are_bit_identical_with_and_without_a_profiler(staged, rec, run):
    off = run(staged)
    assert rec.spans == [] and dict(rec.counters) == {}
    on = recorded(lambda: run(staged))
    assert rec.closed() and dict(rec.counters)
    for a, b in zip(off, on, strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_the_staged_scan_and_the_unified_group_record_their_spans(staged, rec):
    recorded(lambda: _staged(staged))
    names = {s.name: s for s in rec.closed()}
    assert Counter(s.name for s in rec.closed()) == {
        "vo.chunk": 2, "vo.frontend": 2, "vo.sample": 2, "vo.solve": 2, "vo.chain": 1}
    for child in ("vo.frontend", "vo.sample", "vo.solve"):
        assert rec.spans[names[child].parent].name == "vo.chunk"
    assert names["vo.chunk"].parent == names["vo.chain"].parent == -1
    recorded(lambda: _unified(staged))
    parent = {s.name: (rec.spans[s.parent].name if s.parent >= 0 else None)
              for s in rec.closed()}
    assert parent == {"unified.group": None, "unified.tracks": "unified.group",
                      "unified.sample": "unified.group", "unified.vo": "unified.group",
                      "unified.ba": "unified.group", "ba.solve": "unified.ba",
                      "unified.cov": "unified.group", "unified.compose": None}


def test_span_nesting_and_self_time(rec):
    def work():
        with profiling.span("outer"):
            time.sleep(0.004)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.006)

    recorded(work)
    outer, in1, in2 = rec.spans
    assert outer.parent == -1 and in1.parent == in2.parent == 0
    host, own = rec.host_s(), rec.self_s()
    kids = (in1.end_ns - in1.start_ns + in2.end_ns - in2.start_ns) * 1e-9
    assert host["outer"] == pytest.approx((outer.end_ns - outer.start_ns) * 1e-9)
    assert own["outer"] == pytest.approx(host["outer"] - kids, abs=1e-9)
    assert own["inner"] == host["inner"] >= 0.012


def test_a_span_open_across_clear_leaves_the_new_record_alone(rec):
    with torch.profiler.profile(activities=CPU):
        with profiling.span("old"):
            rec.clear()
            with profiling.span("new"):
                pass
    assert [(s.name, s.parent) for s in rec.spans] == [("new", -1)]


def test_spans_share_the_profilers_clock(rec):
    """A span inside a ``record_function`` range is stamped inside it, close
    to both of its ends."""
    with torch.profiler.profile(activities=CPU) as prof:
        for i in range(10):
            with torch.profiler.record_function(f"range{i}"):
                with profiling.span(f"span{i}"):
                    torch.ones(64).sum()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("range")}
    lead, tail = [], []
    for i, s in enumerate(rec.closed()):
        a, b = ranges[f"range{i}"]
        assert a <= s.start_ns <= s.end_ns <= b
        lead.append(s.start_ns - a)
        tail.append(b - s.end_ns)
    assert np.median(lead) < 50_000 and np.median(tail) < 50_000  # ns


def test_trace_writes_spans_into_the_chrome_trace(tmp_path, rec):
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        with profiling.span("stage"):
            torch.ones(8).sum()
    doc = json.loads(path.read_text())
    (s,) = rec.closed()
    (ev,) = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    base = doc.get("baseTimeNanoseconds", 0)
    assert ev["name"] == "stage" and ev["ph"] == "X"
    assert ev["ts"] == pytest.approx((s.start_ns - base) / 1e3, abs=1e-3)
    assert ev["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3, abs=1e-3)
    kernel_pids = {e["pid"] for e in doc["traceEvents"] if e.get("cat") != "program_span"
                   and e.get("ph") == "X"}
    assert ev["pid"] not in kernel_pids  # a track of its own


def _left_through_read(trips, caps):
    return sum(int(t < c) for t, c in zip(trips, caps, strict=True))


def test_klt_trips_and_reads(staged, rec):
    ls = staged[0][:3].to(torch.float32)
    cfg = fe.KLTConfig()
    feats, _, valid = im.detect_features_grid(ls[:2], max_features=64)
    res = recorded(lambda: fe.klt_track(ls[:2], ls[1:3], feats, valid, cfg))
    per_level = res.n_iter.reshape(-1, cfg.n_levels).amax(0).tolist()
    caps = [cfg.iters_coarse] * (cfg.n_levels - 1) + [cfg.iters]
    c = rec.counters
    assert c["klt.calls"] == 1 and c["klt.trips"] == sum(per_level)
    assert c["sync.klt"] == sum(per_level) + _left_through_read(per_level, caps)


def curve(b=5, seed=0):
    ts = torch.linspace(0.0, 3.0, 24)
    g = torch.Generator().manual_seed(seed)
    truth = torch.stack([1 + 2 * torch.rand(b, generator=g), -0.5 - torch.rand(b, generator=g),
                         torch.rand(b, generator=g) - 0.5], -1)
    y = truth[:, :1] * torch.exp(truth[:, 1:2] * ts) + truth[:, 2:3]

    def normal_eq(x):
        e = torch.exp(x[:, 1:2] * ts)
        res = y - (x[:, :1] * e + x[:, 2:3])
        J = torch.stack([e, x[:, :1] * ts * e, torch.ones_like(e)], -1)
        return J.transpose(-1, -2) @ J, (J * res[..., None]).sum(-2), (res * res).mean(-1)

    x0 = truth + 0.3 * (torch.rand(truth.shape, generator=g) - 0.5)
    return normal_eq, x0


@pytest.mark.parametrize("use_lm", [False, True])
def test_lm_trips_and_reads(rec, use_lm):
    normal_eq, x0 = curve()
    cfg = tlm.LMConfig(max_iter=30, use_lm=use_lm, abs_tol=1e-9, incr_tol=1e-6, rel_tol=1e-12)
    res = recorded(lambda: tlm.lm_solve(normal_eq, x0, cfg))
    c = rec.counters
    trips = int(res.n_iter.max())
    assert c["lm.calls"] == 1 and c["lm.trips"] == trips
    assert c["sync.lm"] == trips + int(trips < cfg.max_iter)
    if use_lm:  # one damping loop a trip, each leaving through its read
        assert c["sync.lm_inner"] == c["lm.inner_trips"] + trips
    else:
        assert "lm.inner_trips" not in c and "sync.lm_inner" not in c


def test_ba_trips_and_reads(rec):
    problem, cfg = ba_batch()
    res = recorded(lambda: tba.ba_solve(problem, cfg))
    c = rec.counters
    trips = int(res.n_iter.max())
    assert len(set(res.n_iter.tolist())) > 1  # the batch runs to its slowest window
    assert c["ba.calls"] == 1 and c["ba.trips"] == trips
    assert c["sync.ba"] == trips + int(trips < cfg.max_iter)
    assert [s.name for s in rec.closed()] == ["ba.solve"]


def S(name, a, b, parent=-1):
    return SpanRecord(name, a, b, parent)


def test_attribute_lays_gaps_and_launches_on_the_innermost_span():
    # parent 0-100 with a child 10-40; a second top-level span 120-150
    spans = [S("group", 0, 100), S("tracks", 10, 40, 0), S("compose", 120, 150)]
    device = [(0, 5), (20, 30), (70, 100), (130, 135)]
    launches = [2, 15, 50, 110, 125, 160]
    out = profiling.attribute(device, launches, spans, (0, 170))
    per, outside = out["spans"], out["outside"]
    assert out["window_s"] == pytest.approx(170e-9) and out["busy_s"] == pytest.approx(50e-9)
    # gaps: 5-20 (mid 12.5: tracks), 30-70 (mid 50: group, after its child ended),
    # 100-130 (mid 115: outside), 135-170 (mid 152.5: outside)
    assert per["tracks"]["idle_s"] == pytest.approx(15e-9)
    assert per["group"]["idle_s"] == pytest.approx(40e-9)
    assert per["compose"]["idle_s"] == 0.0
    assert outside["idle_s"] == pytest.approx(65e-9)
    assert [per["group"]["launches"], per["tracks"]["launches"], per["compose"]["launches"],
            outside["launches"]] == [2, 1, 1, 2]
    assert per["group"]["self_s"] == pytest.approx(70e-9)
    assert per["group"]["host_s"] == pytest.approx(100e-9)
    assert outside["host_s"] == pytest.approx(40e-9)
    assert per["group"]["calls"] == per["tracks"]["calls"] == 1


def test_attribute_without_spans_puts_everything_outside():
    out = profiling.attribute([(10, 20)], [5, 15], [], (0, 30))
    assert out["spans"] == {} and out["outside"]["launches"] == 2
    assert out["outside"]["idle_s"] == pytest.approx(20e-9)


READERS = {  # metric -> (what the recorder is filled with, the value)
    "sampler_ms_per_frame.vo": ("vo.sample", 0.5),
    "chain_ms_per_frame.vo": ("vo.chain", 0.5),
    "sampler_ms_per_frame.vo_ba": ("unified.sample", 0.5),
    "compose_ms_per_frame.vo_ba": ("unified.compose", 0.5),
    "klt_trips_per_call.vo": ({"klt.calls": 4, "klt.trips": 54}, 13.5),
    "klt_trips_per_call.vo_ba": ({"klt.calls": 4, "klt.trips": 54}, 13.5),
    "lm_trips_per_solve.vo": ({"lm.calls": 2, "lm.trips": 6, "lm.inner_trips": 1}, 3.5),
    "lm_trips_per_solve.vo_ba": ({"lm.calls": 2, "lm.trips": 7}, 3.5),
    "ba_trips_per_solve.vo_ba": ({"ba.calls": 4, "ba.trips": 44}, 11.0),
}


@pytest.mark.parametrize("metric", list(READERS))
def test_program_metric_readers(rec, metric):
    from vobench import harness

    fill, want = READERS[metric]
    ctx = harness.Ctx(trace=None, syncs=None, work_per_pass=8, windows_per_pass=2, passes=2,
                      k1_bytes=[], lm_iters=[])
    read = harness.load_metric(metric).read
    assert read(ctx) is None  # nothing recorded
    if isinstance(fill, str):  # two spans of 4 ms over 2 passes of 8 steps
        rec.spans += [S(fill, 0, 4_000_000), S(fill, 10_000_000, 14_000_000)]
    else:
        rec.counters.update(fill)
    assert read(ctx) == pytest.approx(want)
