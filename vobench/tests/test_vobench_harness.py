"""The harness: cells, mixes and metrics found by name from files; rates
over every completed pass; the result line's keys; no JAX in a run."""

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SMALL = {"rig": {"fu": 160.0, "fv": 160.0, "cu": 160.0, "cv": 48.0, "height": 96, "width": 320},
         "pipeline": {"max_features": 64, "max_disparity": 32}, "scene": {"hall_half_width": 12.0},
         "traffic": {"frames": 9, "chunk": 4, "wchunk": 2, "windows": 8, "trace_passes": 2}}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_pieces_found_by_name(workload):
    cell, config, traffic, limits = harness.find_cell(BENCH, ROOT, workload)
    assert config["name"] == cell["config"]
    mod = importlib.import_module(f"vobench.engines.{traffic['engine']}")
    assert hasattr(mod, "Engine")
    assert traffic["rate_metric"] in {m["name"] for m in BENCH["end_to_end"]}
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_metric(metric).read)


def test_rate_counts_every_pass_over_the_whole_span():
    def run(stall_at):
        count = [0]

        def one_pass():
            count[0] += 1
            time.sleep(0.25 if count[0] == stall_at else 0.01)

        n, span = harness.run_window(one_pass, 0.3)
        return harness.rate(n, 100, span), n, span

    steady, n0, span0 = run(stall_at=-1)
    stalled, n1, span1 = run(stall_at=2)
    assert span0 >= 0.3 and span1 >= 0.3
    assert stalled < steady
    assert stalled == pytest.approx(n1 * 100 / span1)


@pytest.mark.parametrize("traced", [False, True])
def test_result_has_the_contract_keys_and_checks_last(traced):
    res = harness.run_cell(ROOT, "kitti-ba-windows", 2**31 + 5, 0.01, traced, time.perf_counter(),
                           device="cpu", small=SMALL)
    assert list(res)[:5] == CONTRACT_KEYS
    assert list(res)[-1] == "checks"
    assert set(res) <= set(CONTRACT_KEYS) | {"breakdown", "checks"}
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    e2e = {"ba_windows_per_s", "setup_s"}
    assert (set(res["metrics"]) & e2e) == (set() if traced else e2e)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_means_no_result():
    proc = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", "kitti-vo-offline",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(ROOT)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


IMPORT_CHECK = """
import json, sys, time
from pathlib import Path
from vobench import harness
root = Path(sys.argv[1])
small = json.loads(sys.argv[3])
harness.run_cell(root, sys.argv[2], 7, 0.01, False, time.perf_counter(), device="cpu", small=small)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_no_jax_in_a_run(workload):
    proc = subprocess.run([sys.executable, "-c", IMPORT_CHECK, str(ROOT), workload, json.dumps(SMALL)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "uasl_motion_estimation_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "uasl_motion_estimation_tpu"}
