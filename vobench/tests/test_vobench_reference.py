"""The comparison that decides ``correct``, at a size a CPU test run holds
(a 96 x 320 rig in the 12 m hall, 64 features; 9 frames in chunks of 4, two
flights of 17 frames in groups of 2 windows, 32 BA windows), against the
committed limits:

- a sound run of each cell is correct;
- the control, the plain reference put in the program's place in TF32,
  fails at least one number of each cell;
- with the timed path broken underneath (a step that returns its state
  unchanged; half of the batch left out; an answer altered where it is
  produced), a run comes out not correct.

The card runs the same through ``test_cells_on_the_card``.
"""

import importlib
import time
from pathlib import Path

import pytest
import torch

from uasl_motion_estimation_tpu_torch.models import pipeline as pl
from uasl_motion_estimation_tpu_torch.solvers import ba as pba
from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"rig": {"fu": 160.0, "fv": 160.0, "cu": 160.0, "cv": 48.0, "height": 96, "width": 320},
         "pipeline": {"max_features": 64, "max_disparity": 32}, "scene": {"hall_half_width": 12.0},
         "traffic": {"frames": 9, "chunk": 4, "windows": 32, "trace_passes": 1}}
SMALL_UNIFIED = {**SMALL, "traffic": {"flights": 2, "frames": 17, "wchunk": 2, "trace_passes": 1}}
CELLS = {"kitti-vo-offline": SMALL, "euroc-vo-offline": SMALL,
         "euroc-vo-ba-offline": SMALL_UNIFIED, "kitti-ba-windows": SMALL}


def run(workload, seed=2**31 + 99, device="cpu"):
    return harness.run_cell(ROOT, workload, seed, 0.01, False, time.perf_counter(), device=device,
                            small=CELLS[workload])


def engine(workload, seed=2**31 + 99):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, limits = harness.find_cell(bench, ROOT, workload)
    eng = importlib.import_module(f"vobench.engines.{traffic['engine']}").Engine(
        config, traffic, seed, "cpu", CELLS[workload])
    return eng, limits


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails(workload):
    eng, limits = engine(workload)
    eng.capture.start_pass()
    eng.run_pass()
    eng.release()
    ok, checks = harness.judge(eng.control(eng.capture.judged), limits)
    assert not ok, checks


# -- faults of the timed path, planted underneath the benchmark's capture --

def _vo_unchanged(fn):
    def solve(matches, valid, key, params, init=None, samples=None):
        res = fn(matches, valid, key, params, init=init, samples=samples)
        eye = torch.eye(4, dtype=res.motion.dtype).expand_as(res.motion)
        return res._replace(motion=eye, state=torch.zeros_like(res.state))
    return solve


def _vo_half(fn):
    def solve(matches, valid, key, params, init=None, samples=None):
        res = fn(matches, valid, key, params, init=init, samples=samples)
        b = res.motion.shape[0]
        keep = torch.arange(b) < (b + 1) // 2
        eye = torch.eye(4, dtype=res.motion.dtype)
        lead = (b,) + (1,) * (res.success.ndim - 1)
        return res._replace(motion=torch.where(keep.view(*lead, 1, 1), res.motion, eye),
                            success=res.success & keep.view(lead))
    return solve


def _vo_altered(fn):
    def solve(matches, valid, key, params, init=None, samples=None):
        res = fn(matches, valid, key, params, init=init, samples=samples)
        m = res.motion.clone()
        m[..., 0, 0, 3] += 0.05  # 5 cm on the first step of the batch
        return res._replace(motion=m)
    return solve


def _ba_unchanged(fn):
    def solve(problem, cfg):
        res = fn(problem, cfg)
        return res._replace(cam=problem.cam, pts=problem.pts)
    return solve


def _ba_half(fn):
    def solve(problem, cfg):
        k = problem.cam.shape[0]
        half = fn(pba.BAProblem(*(x[: (k + 1) // 2] for x in problem)), cfg)
        rest = pba.BAProblem(*(x[(k + 1) // 2:] for x in problem))
        full = fn(problem, cfg)
        return full._replace(cam=torch.cat([half.cam, rest.cam]), pts=torch.cat([half.pts, rest.pts]))
    return solve


def _ba_altered(fn):
    def solve(problem, cfg):
        res = fn(problem, cfg)
        cam = res.cam.clone()
        cam[0, -1, 3] += 0.05  # 5 cm on the last camera of the first window
        return res._replace(cam=cam)
    return solve


VO_FAULTS = {"unchanged": _vo_unchanged, "half": _vo_half, "altered": _vo_altered}
BA_FAULTS = {"unchanged": _ba_unchanged, "half": _ba_half, "altered": _ba_altered}


@pytest.mark.parametrize("fault", sorted(VO_FAULTS))
@pytest.mark.parametrize("workload", ["kitti-vo-offline", "euroc-vo-offline"])
def test_staged_vo_fault_is_caught(monkeypatch, workload, fault):
    monkeypatch.setattr(pl, "stereo_vo_solve", VO_FAULTS[fault](pl.stereo_vo_solve))
    assert not run(workload)["correct"]


@pytest.mark.parametrize("fault", sorted(VO_FAULTS))
def test_unified_vo_fault_is_caught(monkeypatch, fault):
    from uasl_motion_estimation_tpu_torch.models import smoother as sm

    monkeypatch.setattr(sm, "stereo_vo_solve", VO_FAULTS[fault](sm.stereo_vo_solve))
    assert not run("euroc-vo-ba-offline")["correct"]


@pytest.mark.parametrize("fault", sorted(BA_FAULTS))
def test_unified_ba_fault_is_caught(monkeypatch, fault):
    from uasl_motion_estimation_tpu_torch.models import smoother as sm

    monkeypatch.setattr(sm, "ba_solve", BA_FAULTS[fault](sm.ba_solve))
    assert not run("euroc-vo-ba-offline")["correct"]


@pytest.mark.parametrize("fault", sorted(BA_FAULTS))
def test_ba_windows_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(pba, "ba_solve", BA_FAULTS[fault](pba.ba_solve))
    assert not run("kitti-ba-windows")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_cells_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's K1 and the card's paths run only there")
    res = run(workload, device="cuda")
    assert res["correct"], res["checks"]
