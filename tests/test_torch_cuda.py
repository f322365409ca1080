"""Tests of the port that need a CUDA card (marker ``cuda``); they skip
where there is none, since a CUDA kernel has no CPU mode: the tile gather
K1, the MI joint histogram K2, and the ported paths against the port's CPU
run (stereo VO, the cross-modal session, the mono engine with its exact
5-point and top-k detector, and the latency mode with its checkpoint). This file imports no jax, so it also runs
where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg

MAIN_PATH_TILES = [(11, 138), (11, 34), (11, 11), (14, 18), (12, 12), (14, 14), (22, 22)]
# the KLT pyramid's levels of a 376x1241 frame, and the smallest images
IMAGES = [(376, 1241), (188, 621), (94, 311), (47, 156), (1, 1), (2, 3)]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU mode")


def edge_anchors(gen, batch, n, h, w):
    """Anchors over and far beyond the image, with the int32 extremes."""
    anc = torch.stack([torch.randint(-300, w + 300, (batch, n), generator=gen),
                       torch.randint(-60, h + 60, (batch, n), generator=gen)], -1)
    anc[:, 0] = torch.tensor([-2**31, 2**31 - 1])
    anc[:, -1] = torch.tensor([2**31 - 1, -2**31])
    return anc.to(torch.int32).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", IMAGES)
@pytest.mark.parametrize("th,tw", MAIN_PATH_TILES + [(1, 1), (3, 5)])
def test_gather_kernel_matches_plain(th, tw, h, w):
    """K1 against its plain version on the card, batch 1 and 13 by n 1, 7
    and 500: negative, out-of-range and int32-extreme anchors; odd tile
    areas (1x1, 3x5) reach the scalar head and tail. Exact (the output is a
    copy); one launch per call."""
    needs_card()
    gen = torch.Generator().manual_seed(th * 1000 + tw + h + w)
    for batch in (1, 13):
        img = (torch.rand(batch, h, w, generator=gen) * 255).cuda()
        for n in (1, 7, 500):
            anc = edge_anchors(gen, batch, n, h, w)
            before = kg.GATHER.launches
            got = kg.gather_tiles(img, anc, th, tw)
            torch.cuda.synchronize()
            assert kg.GATHER.launches == before + 1
            assert torch.equal(got, kg.gather_tiles_plain(img, anc, th, tw)), (batch, n)


@pytest.mark.cuda
def test_gather_kernel_writes_unaligned_output_exactly():
    """The C interface into an output that starts 4, 8 and 12 bytes past a
    16-byte boundary: the scalar head, the vector body and the tail."""
    needs_card()
    gen = torch.Generator().manual_seed(5)
    img = (torch.rand(2, 94, 311, generator=gen) * 255).cuda()
    anc = edge_anchors(gen, 2, 7, 94, 311)
    want = kg.gather_tiles_plain(img, anc, 3, 5)
    fn = kg.GATHER.load()
    for shift in (1, 2, 3):
        buf = torch.full((shift + want.numel() + 4,), -1.0, device="cuda")
        err = fn(img.data_ptr(), anc.data_ptr(), buf[shift:].data_ptr(), 2, 94, 311, 7, 3, 5,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(buf[shift:shift + want.numel()].reshape(want.shape), want)
        assert (buf[:shift] == -1).all() and (buf[shift + want.numel():] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", IMAGES[:4])
@pytest.mark.parametrize("th,tw", MAIN_PATH_TILES)
def test_gather_kernel_matches_grid_sample(th, tw, h, w):
    """K1 against the library yardstick that ``chip_smoke.py`` times
    (``grid_sample``, nearest, border, align_corners), exactly."""
    needs_card()
    smoke = load_chip_smoke()
    gen = torch.Generator().manual_seed(th + tw + h)
    img = (torch.rand(13, h, w, generator=gen) * 255).cuda()
    anc = edge_anchors(gen, 13, 500, h, w)
    assert torch.equal(kg.gather_tiles(img, anc, th, tw), smoke.library_gather(img, anc, th, tw)())


def load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_staged_pipeline_on_card_matches_cpu():
    """The staged slice on the card against the port's CPU run (plain
    kernel versions) with the same RANSAC samples: equal success flags,
    motions within 1e-3."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.utils import synthetic
    from uasl_motion_estimation_tpu_torch.models import pipeline as tp
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=6, rig=rig, seed=0)
    frames = [seq.frame(i) for i in range(6)]
    cfg = tp.default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                            rig.baseline)._replace(max_features=256)
    cpu = tp.OdometryPipeline(cfg, seed=0, device="cpu")

    def sampler(step, valid):
        return cpu._sample(step, valid.cpu()).to(valid.device)

    out = []
    for dev in ("cpu", "cuda"):
        pipe = tp.OdometryPipeline(cfg, seed=0, device=dev, sampler=sampler)
        ls, rs = pipe.stage_frames(frames)
        out.append(tp._vo_scan_packed(ls, rs, 0, sampler, cfg, 3).cpu().numpy())
    np.testing.assert_array_equal(out[0][:, 16], out[1][:, 16])
    np.testing.assert_allclose(out[1][:, :16], out[0][:, :16], atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("rep,p,bins,sentinel", [
    (128, 121, 20, None),  # the MI matcher: 13 x 500 left patches x 128 candidates
    (1, 121, 20, None),  # the scale LM
    (128, 121, 20, 20), (1, 81, 32, 25), (1, 121, 20, 31), (128, 81, 32, 400),
])
def test_mi_kernel_matches_plain(rep, p, bins, sentinel):
    """K2 against its plain version on the card at the path shapes, with ids
    out of [0, bins) in qa: 1e-5 absolute (exact integer counts; only the
    final float32 sum rounds, in another order)."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    gen = torch.Generator().manual_seed(rep + p + bins)
    qa = torch.randint(0, bins, (13 * 500, p), generator=gen, dtype=torch.int32)
    if sentinel is not None:
        qa[::3, -5:] = sentinel
    qb = torch.randint(0, bins, (13 * 500 * rep, p), generator=gen, dtype=torch.int32)
    qa, qb = qa.cuda(), qb.cuda()
    before = kmi.MI.launches
    got = kmi.mi_pairs(qa, qb, rep=rep, bins=bins)
    torch.cuda.synchronize()
    assert kmi.MI.launches == before + 1
    want = kmi.mi_pairs_plain(qa, qb, rep, p, bins)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_disp,bins", [
    (11, 128, 20),  # the MI matcher: 13 x 500 features x 128 disparities
    (9, 128, 32),
    (11, 64, 20),
])
def test_mi_strip_kernel_matches_plain(k, n_disp, bins):
    """K2's strip mode against its plain version on the card, 1e-5 absolute;
    one strip launch counted. A flat strip and a feature whose strip holds an
    id outside [0, bins) (NaN scores) are among the features."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi

    gen = torch.Generator().manual_seed(k + n_disp + bins)
    n_feat = 13 * 500
    qa = torch.randint(0, bins, (n_feat, k * k), generator=gen, dtype=torch.uint8)
    strip = torch.randint(0, bins, (n_feat, k, n_disp + k - 1), generator=gen,
                          dtype=torch.uint8)
    strip[1] = 3
    qa, strip = qa.cuda(), strip.cuda()
    before, before_strip = kmi.MI.launches, kmi.MI.strip_launches
    got = kmi.mi_strip(qa, strip, bins)
    torch.cuda.synchronize()
    assert (kmi.MI.launches, kmi.MI.strip_launches) == (before + 1, before_strip + 1)
    want = kmi.mi_strip_plain(qa, strip, bins)
    assert got.shape == (n_feat, n_disp)
    assert float((got - want).abs().max()) <= 1e-5
    strip[7, 2, 5] = bins
    bad = kmi.mi_strip(qa, strip, bins)
    assert torch.isnan(bad[7]).all() and torch.equal(bad[8:], got[8:])


@pytest.mark.cuda
def test_mi_router_refuses_one_hot_on_card():
    needs_card()
    from uasl_motion_estimation_tpu_torch.ops import similarity as sim

    x = torch.zeros((4, 11, 11), device="cuda")
    with pytest.raises(ValueError):
        sim.mutual_information_batched(x, x, use_pallas=False)


@pytest.mark.cuda
def test_cross_modal_session_on_card_matches_cpu():
    """The small cross-modal session (192x320, 6 frames, seed 3, 256
    features, 64 disparities) on the card against the port's CPU run with
    the same RANSAC samples: equal vo_success, scales within 1e-2 relative
    and rotations within 1e-3 (MI is quantised: a float32 difference can
    move a pixel across a bin edge and nudge the MI-LM's end point)."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.models import cross_modal as tcm
    from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu_torch.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu_torch.models.mono_pipeline import make_mono_samplers
    from uasl_motion_estimation_tpu_torch.models.scale import ScaleConfig
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.ops.kernels import mi as kmi
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=6, rig=rig, seed=3, cross_modal=True)
    frames = [seq.frame(i) for i in range(6)]
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = tcm.CrossModalConfig(vo=MonoVOParams(intr=intr),
                               scale=ScaleConfig(intr=intr, baseline=rig.baseline),
                               matcher=MatcherConfig(max_disparity=64), max_features=256)
    cpu_sampler = make_mono_samplers(0, cfg.vo)[0]

    def sampler(step, valid):
        return cpu_sampler(step, valid.cpu()).to(valid.device)

    cpu = tcm.run_cross_modal_staged(frames, cfg, chunk=5, device="cpu", sampler=sampler)
    before, before_strip = kmi.MI.launches, kmi.MI.strip_launches
    card = tcm.run_cross_modal_staged(frames, cfg, chunk=5, device="cuda", sampler=sampler)
    assert kmi.MI.strip_launches > before_strip  # the matcher
    assert kmi.MI.launches - kmi.MI.strip_launches > before - before_strip  # the scale LM
    assert [r["success"] for r in card.records] == [r["success"] for r in cpu.records]
    np.testing.assert_allclose(card.scales, cpu.scales, rtol=1e-2)
    np.testing.assert_allclose(card.trajectory[:, :3, :3], cpu.trajectory[:, :3, :3], atol=1e-3)


def two_view_scenes(n: int, seed: int = 0):
    """n random 5-point two-view scenes (normalized coordinates), as in
    tests/test_fivepoint.py: a 0.2 rad rotation, a unit translation, depths
    4-10."""
    rng = np.random.default_rng(seed)
    x1s, x2s = [], []
    for _ in range(n):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(0.2) * K + (1 - np.cos(0.2)) * K @ K
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = rng.uniform(-2, 2, size=(5, 3))
        X[:, 2] = rng.uniform(4, 10, size=5)
        X2 = X @ R.T + t
        x1s.append(X[:, :2] / X[:, 2:3])
        x2s.append(X2[:, :2] / X2[:, 2:3])
    return (torch.from_numpy(np.stack(x1s).astype(np.float32)),
            torch.from_numpy(np.stack(x2s).astype(np.float32)))


@pytest.mark.cuda
def test_fivepoint_on_card_matches_cpu():
    """The exact 5-point on the card against its CPU run, given the same
    (CPU) nullspace basis of 200 scenes. det M(z) is a float32 10x10
    determinant whose sign near a grid node's zero can differ between two
    evaluation orders, which adds or drops a bracket
    (tests/test_torch_fivepoint.py measures the same against JAX). Held:
    a median difference below 1e-4 per entry of a unit-norm E where both
    keep a candidate, at least 75 % of those within 1e-3, and at least 80 %
    of all candidates of either run found by the other within 1e-3
    (``chip_smoke.candidate_agreement``; measured on the H100: 1.3e-5, 90 %
    and 86.5 %). The card's own basis (its SVD) meets the solver's
    contract: epipolar residual below 5e-3 for 90 % of its candidates
    (measured 97 %)."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.ops import fivepoint as tfp

    x1, x2 = two_view_scenes(200)
    basis = tfp.nullspace_basis(x1, x2)
    Ec, vc = tfp.candidates_from_basis(basis)
    Eg, vg = (a.cpu() for a in tfp.candidates_from_basis(basis.cuda()))
    agree = load_chip_smoke().candidate_agreement(Eg, vg, Ec, vc)
    print("five-point, card vs CPU on one basis:", agree)
    assert agree["median"] < 1e-4 and agree["within"] >= 0.75 and agree["found"] >= 0.8
    E, v = (a.cpu() for a in tfp.fivepoint_candidates(x1.cuda(), x2.cuda()))
    h1 = torch.cat([x1, torch.ones(200, 5, 1)], -1).double()
    h2 = torch.cat([x2, torch.ones(200, 5, 1)], -1).double()
    epi = torch.einsum("sni,srij,snj->srn", h2, E.double(), h1).abs().amax(-1)
    print("five-point on the card, own basis: share of candidates with epipolar residual "
          "< 5e-3:", float((epi[v] < 5e-3).float().mean()))
    assert (epi[v] < 5e-3).float().mean() >= 0.9


@pytest.mark.cuda
def test_detect_features_on_card_matches_cpu(monkeypatch):
    """The top-k detector on the card against the CPU on a rendered frame
    pair (batch 2): equal masks, the same features in the same order
    (sub-pixel xy within 1e-4 px); and on a response map built with ties,
    exactly equal (ties go to the lower linear index)."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.ops import image as tim
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=2, rig=rig, seed=3)
    imgs = torch.from_numpy(np.stack([seq.frame(i)[0] for i in range(2)]).astype(np.float32))
    c = tim.detect_features(imgs, 256, 0.01, 5)
    g = [a.cpu() for a in tim.detect_features(imgs.cuda(), 256, 0.01, 5)]
    assert torch.equal(c[2], g[2]) and c[2].sum() > 200
    torch.testing.assert_close(g[0], c[0], atol=1e-4, rtol=0)
    resp = torch.zeros(48, 80)
    resp[12, 60] = resp[12, 20] = resp[30, 40] = 1.0
    monkeypatch.setattr(tim, "shi_tomasi_response", lambda img, window_radius=2: img)
    c = tim.detect_features(resp, 40, 0.01, 5)
    g = [a.cpu() for a in tim.detect_features(resp.cuda(), 40, 0.01, 5)]
    for a, b in zip(c, g):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mono_staged_on_card_matches_cpu():
    """run_mono_staged on the card against the CPU (192x320, 6 frames,
    seed 3, 64 hypotheses) with the same CPU-drawn samples, the hybrid
    escalating every step (hybrid_ratio 2), so K1 (KLT) and the exact
    5-point both run on the card: equal success flags and escalations,
    positions within 5e-3 m, rotations within 1e-3."""
    needs_card()
    from uasl_motion_estimation_tpu_torch.models import mono_pipeline as tmp
    from uasl_motion_estimation_tpu_torch.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=6, rig=rig, seed=3)
    frames = [seq.frame(i)[0] for i in range(6)]
    vo = MonoVOParams(intr=Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), inlier_threshold=2.0,
                      solver="hybrid", hybrid_ratio=2.0, n_ransac=64)
    cfg = tmp.MonoPipelineConfig(vo=vo, max_features=256)
    cpu = tmp.make_mono_samplers(0, vo)

    def on(sampler):
        return lambda step, valid: sampler(step, valid.cpu()).to(valid.device)

    out = []
    for dev in ("cpu", "cuda"):
        stats = {}
        before = kg.GATHER.launches
        traj = tmp.run_mono_staged(frames, cfg, initial_speed=0.8, chunk=3, device=dev,
                                   sampler=on(cpu[0]), sampler5=on(cpu[1]), stats=stats)
        out.append((traj, stats, kg.GATHER.launches - before))
    (tc, sc, _), (tg, sg, launches) = out
    assert launches > 0
    assert sc["success"] == sg["success"] and sc["escalated"] == sg["escalated"] == list(range(5))
    np.testing.assert_allclose(tg[:, :3, 3], tc[:, :3, 3], atol=5e-3)
    np.testing.assert_allclose(tg[:, :3, :3], tc[:, :3, :3], atol=1e-3)


@pytest.mark.cuda
def test_latency_mode_card_matches_cpu():
    """The latency mode (``OdometrySystem``, BA every 2 keyframes, parallax
    gate 1 px) on a small world on the card against the port's CPU run
    (plain kernel versions) with the same RANSAC samples: the same keyframe
    decisions and successes, poses within 1e-3 m; ``device=None`` is the
    card; a checkpoint taken on the card resumes on the card to within
    1e-5 m of the uninterrupted run."""
    needs_card()
    import tempfile

    from uasl_motion_estimation_tpu_torch.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu_torch.models.odometry import OdometryConfig, OdometrySystem
    from uasl_motion_estimation_tpu_torch.models.pipeline import make_sampler
    from uasl_motion_estimation_tpu_torch.models.stereo_vo import StereoVOParams
    from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic
    from uasl_motion_estimation_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=9, rig=rig, seed=4)
    frames = [seq.frame(i) for i in range(9)]
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = OdometryConfig(vo=StereoVOParams(intr1=intr, intr2=intr, baseline=rig.baseline),
                         max_tracks=256, window=3, ba_rate=2, parallax=1.0,
                         matcher=MatcherConfig(max_disparity=96))
    cpu_sampler = make_sampler(1, cfg.vo.n_ransac)

    def sampler(step, valid):
        return cpu_sampler(step, valid.cpu()).to(valid.device)

    runs = {}
    for dev in ("cpu", None):
        log = metrics.MetricsLogger()
        system = OdometrySystem(cfg, seed=1, logger=log, device=dev, sampler=sampler)
        runs[dev] = (system.run(frames), log.records, system.device.type)
    (cpu_traj, cpu_recs, _), (traj, recs, kind) = runs["cpu"], runs[None]
    assert kind == "cuda"
    for key in ("keyframe", "success"):
        assert [r.get(key) for r in recs] == [r.get(key) for r in cpu_recs], key
    assert any("ba_cost" in r for r in recs)
    np.testing.assert_allclose(traj[:, :3, 3], cpu_traj[:, :3, 3], rtol=0, atol=1e-3)

    first = OdometrySystem(cfg, seed=1, sampler=sampler)
    first.run(frames[:4])
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(f"{d}/c.npz", first)
        resumed = OdometrySystem(cfg, seed=1, sampler=sampler)
        load_checkpoint(f"{d}/c.npz", resumed)
    np.testing.assert_allclose(resumed.run(frames[4:])[:, :3, 3], traj[:, :3, 3], rtol=0,
                               atol=1e-5)
