"""The per-layer metrics read from the program's own spans and counters
(``uasl_motion_estimation_tpu_torch/utils/profiling.py``, read through
``vobench/program.py``): a traced run of each cell they list reports them,
and a program without the recorder reads None and raises nothing."""

import time

import pytest

from vobench import harness, program

from test_vobench_harness import BENCH, ROOT, SMALL  # this directory is on sys.path

PROGRAM = [m for m in BENCH["per_layer"]
           if "vobench.program" in (harness.PKG / "metrics" / f"{m['name']}.py").read_text()]
BOUNDS = {"ms": (0.0, 1e4), "count": (1.0, 1e3)}
KLT_MOST = 3 * 4 + 10  # trips of a call at KLTConfig's defaults


@pytest.mark.parametrize("workload", ["kitti-vo-offline", "euroc-vo-ba-offline"])
def test_a_traced_run_reports_the_program_metrics(workload):
    program.recorder().clear()  # one run per process in the benchmark; here several
    res = harness.run_cell(ROOT, workload, 2**31 + 11, 0.01, True, time.perf_counter(),
                           device="cpu", small=SMALL)
    want = {m["name"]: m["unit"] for m in PROGRAM if workload in m["workloads"]}
    assert len(want) in (4, 5)
    for name, unit in want.items():
        assert res["metrics"][name]["unit"] == unit
        lo, hi = BOUNDS[unit]
        assert lo < res["metrics"][name]["value"] <= (KLT_MOST if "klt" in name else hi), name
    others = {m["name"] for m in PROGRAM} - set(want)
    assert not others & set(res["metrics"])


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from uasl_motion_estimation_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorder")
    ctx = harness.Ctx(trace=None, syncs=None, work_per_pass=8, windows_per_pass=2, passes=2,
                      k1_bytes=[], lm_iters=[])
    assert len(PROGRAM) == 9
    for m in PROGRAM:
        assert harness.load_metric(m["name"]).read(ctx) is None
