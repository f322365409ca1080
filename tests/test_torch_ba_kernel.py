"""Kernel K3 (``ops/kernels/ba_schur.py``, ``csrc/ba_schur.cu``): windowed
BA's reduction (kernel A: the damped, gauged reduced camera system, its
right-hand side and the cost) and step (kernel B: the points
back-substituted and clamped, the new state priced), against the plain chain
of ``solvers/ba.py`` (``_reduce_plain``, ``_step_plain``).

On the CPU: ``ba_solve`` and ``ba_camera_covariances`` take the plain chain
for CPU tensors and never touch the kernel; the loop's kernel branch (its
hand-offs, the dense solve between, the ``ba.fused`` counter) run with
stand-ins that call the plain chain; the wrapper's checks. On a card
(marker ``cuda``; this file imports no jax):

    python -m pytest tests/test_torch_ba_kernel.py -m cuda --noconftest -p no:cacheprovider
"""

import contextlib

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.ops.kernels import ba_schur as kba
from uasl_motion_estimation_tpu_torch.solvers import ba as tba
from uasl_motion_estimation_tpu_torch.utils import profiling, synthetic

torch.set_num_threads(1)
CONFIG4_INTR, CONFIG4_BASELINE = (400.0, 400.0, 320.0, 240.0), 0.5
# (windows, frames, points, stereo): cell kitti-ba-windows' and config 4's
# window shape, the integrated engine's (5 frames), a mono window (2 residuals)
SHAPES = {"w10_m256_r4": (8, 10, 256, True), "w5_m200_r4": (8, 5, 200, True),
          "w6_m120_r2": (8, 6, 120, False)}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU mode")


def windows(n, frames, points, stereo=True, outliers=True, seed0=0):
    """``n`` of config 4's windows (``synthetic.ba_window``, seeds seed0...,
    each started from its perturbation), with 12 gross outliers (30-80 px) a
    window, a point seen once and a point never seen: every branch of the
    Huber weight and of a point's validity."""
    intr = Intrinsics(*CONFIG4_INTR)
    out = []
    for s in range(seed0, seed0 + n):
        cams, pts, obs, mask = synthetic.ba_window(intr, CONFIG4_BASELINE, n_frames=frames,
                                                   n_pts=points, noise=0.3, stereo=stereo, seed=s)
        cams, pts = synthetic.perturb_ba_window(cams, pts, seed=s + 100)
        if outliers:
            rng = np.random.default_rng(s + 7)
            w, m = rng.integers(0, frames, 12), rng.integers(0, points, 12)
            obs[w, m] += rng.uniform(30, 80, (12, obs.shape[-1])).astype(np.float32)
            mask[:, points - 3] = False
            mask[1, points - 3] = True
            mask[:, points - 2] = False
        out.append((cams, pts, obs, mask))
    cfg = tba.BAConfig(intr=intr, baseline=CONFIG4_BASELINE if stereo else 0.0, n_fixed=2)
    return tba.BAProblem(*(torch.from_numpy(np.stack(x)) for x in zip(*out))), cfg


def recorded(fn):
    profiling.recorder().clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counters = dict(profiling.recorder().counters)
    profiling.recorder().clear()
    return out, counters


def test_cpu_tensors_take_the_plain_chain():
    """On the CPU ``ba_solve`` and ``ba_camera_covariances`` never reach the
    kernel (which would raise there), and no ``ba.fused`` is counted."""
    prob, cfg = windows(2, 4, 24)
    before = kba.BA_SCHUR.launches
    res, counters = recorded(lambda: tba.ba_solve(prob, cfg))
    tba.ba_camera_covariances(prob._replace(cam=res.cam, pts=res.pts), cfg)
    assert kba.BA_SCHUR.launches == before
    assert counters["ba.trips"] == int(res.n_iter.max()) > 0 and "ba.fused" not in counters
    with pytest.raises(ValueError, match="no kernel"):
        kba.reduce(*prob, torch.zeros(2), None, torch.ones(2, 24, dtype=torch.bool),
                   intr=cfg.intr, baseline=cfg.baseline, huber_delta=1.0, n_fixed=2)


def test_kernel_branch_of_the_loop(monkeypatch):
    """The loop's kernel branch on the CPU, with kernels A and B replaced by
    the plain chain: the same result bit for bit as the plain branch, kernel
    A's per-point output handed to kernel B unchanged, the done latch passed
    to both, and ``ba.fused`` counting every trip."""
    prob, cfg = windows(3, 5, 40)
    want, counters = recorded(lambda: tba.ba_solve(prob, cfg))
    calls = []

    def reduce(cam, pts, obs, mask, lam, done, pt_valid, *, v_eps, want_aux, **kw):
        assert mask.dtype == done.dtype == torch.bool and want_aux and v_eps == 0.0
        out = tba._reduce_plain(cam, pts, obs, mask.to(cam.dtype), lam, pt_valid, cfg, v_eps)
        calls.append(("A", id(out[3])))
        return out

    def step(cam, pts, obs, mask, dcam, aux, done, pt_valid, *, zlim, **kw):
        assert calls[-1] == ("A", id(aux)) and zlim == tba._depth_limits(cfg)
        calls.append(("B", done.clone()))
        return tba._step_plain(cam, pts, obs, mask.to(cam.dtype), dcam, aux, pt_valid, cfg)

    monkeypatch.setattr(tba, "_on_card", lambda t: True)
    monkeypatch.setattr(tba, "_cusolver", contextlib.nullcontext)
    monkeypatch.setattr(tba.kba, "reduce", reduce)
    monkeypatch.setattr(tba.kba, "step", step)
    got, fused = recorded(lambda: tba.ba_solve(prob, cfg))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    trips = counters["ba.trips"]
    assert fused["ba.fused"] == fused["ba.trips"] == trips == len(calls) // 2
    assert len({int(n) for n in want.n_iter}) > 1  # the latch holds a finished window
    assert not calls[1][1].any() and calls[-1][1].any()


def test_solve_pads_a_lone_system(monkeypatch):
    """On a card a lone system is solved in a batch of two with the
    identity; the answer and its shape are the plain solve's."""
    monkeypatch.setattr(tba, "_on_card", lambda t: True)
    monkeypatch.setattr(tba, "_cusolver", contextlib.nullcontext)
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(6, 6, generator=gen, dtype=torch.float64)
    S, rhs = a @ a.T + torch.eye(6, dtype=torch.float64), torch.randn(6, dtype=torch.float64)
    for lead in ((), (1,), (3,)):
        x, info = tba._solve(S.expand(*lead, 6, 6), rhs.expand(*lead, 6))
        assert x.shape == (*lead, 6) and info.shape == lead and not info.any()
        torch.testing.assert_close(x, torch.linalg.solve(S, rhs).expand(*lead, 6))


def wrapper_args(bad: str, device: str = "cpu"):
    """Arguments of kernel A at 10 frames x 16 points, with one fault."""
    prob, cfg = windows(2, 33 if bad == "frames" else 10, 16, outliers=False)
    cam, pts, obs, mask = (t.to(device) for t in prob)
    lam = torch.zeros(2, device=device)
    valid = torch.ones(2, 16, dtype=torch.bool, device=device)
    baseline = cfg.baseline
    if bad == "dtype":
        cam = cam.double()
    elif bad == "contiguous":
        obs = obs.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mask":
        mask = mask.float()
    elif bad == "residuals":
        baseline = 0.0
    elif bad == "shape":
        valid = valid[:, :8]
    return (cam, pts, obs, mask, lam, None, valid), dict(
        intr=cfg.intr, baseline=baseline, huber_delta=1.0, n_fixed=2)


FAULTS = {"frames": (ValueError, "frames a window"), "dtype": (TypeError, "cam must be"),
          "contiguous": (ValueError, "contiguous"), "mask": (TypeError, "mask must be"),
          "residuals": (ValueError, "residuals"), "shape": (ValueError, "pt_valid has shape")}


@pytest.mark.parametrize("bad", list(FAULTS))
def test_wrapper_raises_before_any_launch(bad):
    """The checks run before the device's: a window over 32 frames, a wrong
    dtype, a non-contiguous input, a float mask, residuals that do not match
    the baseline, a wrong shape."""
    args, kw = wrapper_args(bad)
    err, match = FAULTS[bad]
    with pytest.raises(err, match=match):
        kba.reduce(*args, **kw)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", ["solve", "covariance"])
def test_kernels_match_the_plain_chain(shape, mode):
    """Kernels A and B against the plain chain, both held to the float64
    chain by ``chip_smoke.hold_ba_schur``: the kernel's gap may be
    ``BA_GAP_X`` (4) times the float32 chain's plus ``BA_GAP_FLOOR`` (1e-6)
    of the largest entry, since both sum the same float32 terms in other
    orders and the kernel inverts V by its adjugate where the chain factors
    it (measured: at most 2.2 times). Modes: the solve's damping (lam 1e-4),
    and the covariances' (lam 0, V + 1e-9 I). The cameras after the step are
    the chain's exactly (the same add); every update finite."""
    needs_card()
    import chip_smoke

    n, frames, points, stereo = SHAPES[shape]
    prob, cfg = windows(n, frames, points, stereo)
    chip_smoke.hold_ba_schur(tuple(t.cuda() for t in prob), cfg, shape,
                             v_eps=1e-9 if mode == "covariance" else 0.0)


@pytest.mark.cuda
def test_batch_equals_solo_bit_for_bit():
    """A window's kernel outputs, and its whole ``ba_solve``, are the same
    bits in a batch of 16 as alone (kernels A and B sum in an order fixed by
    the window's shape; every dense solve takes cuBLAS's batched LU), and two
    runs agree bit for bit."""
    needs_card()
    prob, cfg = windows(16, 10, 256)
    p = tba.BAProblem(*(t.cuda() for t in prob))
    valid = torch.sum(p.mask.float(), -2) >= 2
    lam = torch.full((16,), 1e-4, device="cuda")
    done = torch.zeros(16, dtype=torch.bool, device="cuda")
    kw = dict(intr=cfg.intr, baseline=cfg.baseline, huber_delta=cfg.huber_delta)
    ka = kba.reduce(*p, lam, done, valid, n_fixed=cfg.n_fixed, **kw)
    dcam = torch.linalg.solve(ka[0], ka[1][..., None]).reshape(p.cam.shape).contiguous()
    kb = kba.step(*p, dcam, ka[3], done, valid, zlim=tba._depth_limits(cfg), **kw)
    res = tba.ba_solve(p, cfg)
    assert all(torch.equal(a, b) for a, b in zip(res, tba.ba_solve(p, cfg), strict=True))
    assert all(torch.equal(a, b) for a, b in zip(
        ka, kba.reduce(*p, lam, done, valid, n_fixed=cfg.n_fixed, **kw), strict=True))
    for i in (0, 7, 15):
        one = tba.BAProblem(*(t[i:i + 1].contiguous() for t in p))
        sa = kba.reduce(*one, lam[i:i + 1], done[i:i + 1], valid[i:i + 1], n_fixed=cfg.n_fixed,
                        **kw)
        sb = kba.step(*one, dcam[i:i + 1].contiguous(), sa[3], done[i:i + 1], valid[i:i + 1],
                      zlim=tba._depth_limits(cfg), **kw)
        assert all(torch.equal(a[i:i + 1], b) for a, b in zip(ka, sa, strict=True)), i
        assert all(torch.equal(a[i:i + 1], b) for a, b in zip(kb, sb, strict=True)), i
        alone = tba.ba_solve(tba.BAProblem(*(t[0] for t in one)), cfg)
        assert all(torch.equal(a[i], b) for a, b in zip(res, alone, strict=True)), i


@pytest.mark.cuda
@pytest.mark.parametrize("bad", list(FAULTS))
def test_wrapper_raises_on_the_card(bad):
    needs_card()
    args, kw = wrapper_args(bad, "cuda")
    err, match = FAULTS[bad]
    with pytest.raises(err, match=match):
        kba.reduce(*args, **kw)


@pytest.mark.cuda
def test_done_windows_get_the_identity_and_keep_their_state():
    needs_card()
    prob, cfg = windows(4, 5, 40)
    p = tba.BAProblem(*(t.cuda() for t in prob))
    valid = torch.sum(p.mask.float(), -2) >= 2
    done = torch.tensor([False, True, False, True], device="cuda")
    kw = dict(intr=cfg.intr, baseline=cfg.baseline, huber_delta=cfg.huber_delta)
    S, rhs, _, aux = kba.reduce(*p, torch.full((4,), 1e-4, device="cuda"), done, valid,
                                n_fixed=cfg.n_fixed, **kw)
    cam, pts, _, _ = kba.step(*p, torch.ones_like(p.cam), aux, done, valid,
                              zlim=tba._depth_limits(cfg), **kw)
    eye = torch.eye(30, device="cuda")
    assert torch.equal(S[1], eye) and torch.equal(S[3], eye) and not rhs[done].any()
    assert torch.equal(cam[done], p.cam[done]) and torch.equal(pts[done], p.pts[done])
    assert not torch.equal(S[0], eye) and not torch.equal(cam[0], p.cam[0])


@pytest.mark.cuda
def test_ba_solve_on_the_card_converges_as_the_plain_chain():
    """Config 4's 16 windows: every window converged on the card, as in the
    plain chain on the CPU; iterations within one (a float32 tie at a
    window's last step), costs within 1e-5 relative, cameras within 1e-4.
    Every trip ran kernels A and B (two launches), and the covariances take
    kernel A once, within 1e-3 of the plain chain's largest entry."""
    needs_card()
    prob, cfg = windows(16, 10, 256, outliers=False)
    want = tba.ba_solve(prob, cfg)
    before = kba.BA_SCHUR.launches
    got, counters = recorded(lambda: tba.ba_solve(tba.BAProblem(*(t.cuda() for t in prob)), cfg))
    assert kba.BA_SCHUR.launches - before == 2 * counters["ba.trips"]
    assert counters["ba.fused"] == counters["ba.trips"] == int(got.n_iter.max())
    assert bool(got.converged.all()) and bool(want.converged.all())
    assert int((got.n_iter.cpu() - want.n_iter).abs().max()) <= 1
    np.testing.assert_allclose(got.cost.cpu().numpy(), want.cost.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.cam.cpu().numpy(), want.cam.numpy(), atol=1e-4)
    solved = prob._replace(cam=want.cam, pts=want.pts)
    cov = tba.ba_camera_covariances(solved, cfg)
    before = kba.BA_SCHUR.launches
    cov_card = tba.ba_camera_covariances(tba.BAProblem(*(t.cuda() for t in solved)), cfg)
    assert kba.BA_SCHUR.launches - before == 1
    np.testing.assert_allclose(cov_card.cpu().numpy(), cov.numpy(),
                               atol=1e-3 * float(cov.abs().max()))
