"""The port's unified VO+BA engine (``models/smoother.py``) against the JAX
reference, and its engines against each other, on the 192x320 rig with
``max_features=256``.

The JAX reference runs once (module fixture) on a 9-frame world (2
windows): the whole ``unified_system_scan`` with RANSAC seed 1, and its
``_build_window_tracks``. With the JAX-drawn samples injected through the
engine's ``sampler`` (keyed on the global motion index) the port must
succeed on the same motions, give VO and refined motions within 1e-4 on
rotation entries and 1e-3 m on translation, keep the gated observations
per window frame within 2 % of the feature budget, and give the VO, BA
camera and refined-motion covariances, and the per-frame pose
covariances composed from them, within 1e-3 of each one's largest entry.
The host composer on JAX's own outputs equals JAX's to 1e-12.

Track tables: every window's KLT runs as many iterations at every level of
every frame as JAX's (read from JAX through an ordered debug callback on
its ``while_loop``); masks agree on >= 98 % of the entries; where both
hold, the observations agree within 1e-3 px, except at entries whose
float32 answer is itself more than 1e-3 px from the exact one: there
JAX's float32 table is that far from the port's float64 table, and the
port's float32 table must be no farther from it than JAX's is, plus
1e-3 px; no entry may differ by more than ``converge_px`` (0.03 px). On
this world that is one track of window 1 whose last two
frames sit 3.2e-3 and 4.4e-3 px from the float64 answer in JAX and
2.3e-3 and 3.1e-3 px in the port, on opposite sides.

Port only: ``run_unified_streaming`` equals ``run_unified_system`` on the
motions both solve with the same windows (frames 0-16 of 22), its
resume/merge equals the unbroken streaming run, and with its own sampler on
the clean 17-frame world every window converges and BA lowers the ATE.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gather import load_module
from test_torch_pipeline import jax_sampler
from uasl_motion_estimation_tpu.models import frontend as jfe
from uasl_motion_estimation_tpu.models import pipeline as jpipe
from uasl_motion_estimation_tpu.models import smoother as jsm
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics as JaxIntrinsics
from uasl_motion_estimation_tpu.parallel.stitching import chain_covariances_np as jax_chain
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import smoother as tsm
from uasl_motion_estimation_tpu_torch.models.frontend import KLTConfig
from uasl_motion_estimation_tpu_torch.models.pipeline import default_config
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
from uasl_motion_estimation_tpu_torch.parallel.stitching import chain_covariances_np
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
N_JAX = 9  # two windows of 5 at stride 4


def port_cfg(**over) -> tsm.SmootherConfig:
    pipe = default_config(Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv),
                          RIG.baseline)._replace(max_features=256)
    return tsm.SmootherConfig(pipe=pipe, **over)


def render(n: int, seed: int = 4):
    seq = synthetic.SyntheticStereoSequence(n_frames=n, rig=RIG, seed=seed)
    return seq, [seq.frame(i) for i in range(n)]


def staged(frames):
    ls = np.clip(np.stack([f[0] for f in frames]), 0, 255).astype(np.uint8)
    rs = np.clip(np.stack([f[1] for f in frames]), 0, 255).astype(np.uint8)
    return ls, rs


def jax_tracks_and_klt_iterations(ls, rs, starts, jcfg):
    """JAX's ``_build_window_tracks`` of the windows at ``starts``, and the
    iterations each window's KLT ran at each pyramid level of each later
    frame (K, W-1, levels; coarsest level first). ``lax.while_loop`` is
    wrapped while the table is traced (KLT's loops are its only ones): each
    loop hands its final count to an ordered debug callback, which vmap
    unrolls over the windows, so the counts arrive frame by frame, window by
    window, one list per level."""
    counts: dict = {}
    real = jax.lax.while_loop

    def record(level, i):
        counts.setdefault(level, []).append(int(i))

    def recording(cond, body, init):
        out = real(cond, body, init)
        jax.debug.callback(functools.partial(record, len(counts)), out[0], ordered=True)
        counts.setdefault(len(counts), [])
        return out

    jfe.klt_track.clear_cache()  # klt_track is jitted: trace it anew
    jax.lax.while_loop = recording
    try:
        tracks = jax.jit(jsm._build_window_tracks, static_argnames="cfg")
        obs, mask = jax.device_get(tracks(jnp.asarray(ls, jnp.float32),
                                          jnp.asarray(rs, jnp.float32), jnp.asarray(starts),
                                          cfg=jcfg))
    finally:
        jax.lax.while_loop = real
        jfe.klt_track.clear_cache()
    levels, k, w = jcfg.pipe.klt.n_levels, len(starts), jcfg.window
    assert sorted(counts) == list(range(levels))
    iters = np.array([counts[lv] for lv in range(levels)]).reshape(levels, w - 1, k)
    return np.asarray(obs), np.asarray(mask), iters.transpose(2, 1, 0)


@pytest.fixture(scope="module")
def world():
    _, frames = render(N_JAX)
    ls, rs = staged(frames)
    jcfg = jsm.SmootherConfig(pipe=jpipe.default_config(
        JaxIntrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv), RIG.baseline)._replace(max_features=256))
    out = jax.device_get(jsm.unified_system_scan(jnp.asarray(ls), jnp.asarray(rs),
                                                 jax.random.key(1), jcfg, wchunk=2))
    starts = jsm.unified_window_starts(N_JAX, jcfg.window, jcfg.ba_rate)
    return (ls, rs, jcfg, out, starts, *jax_tracks_and_klt_iterations(ls, rs, starts, jcfg))


@pytest.mark.parametrize("n, window, stride, want", [
    (17, 5, 4, [0, 4, 8, 12]),  # every motion exactly once
    (19, 5, 4, [0, 4, 8, 12, 14]),  # a clamped final window covers the tail
    (11, 5, 2, [0, 2, 4, 6]),  # overlapping cadence
    (4, 5, 4, []),  # too short: no windows
])
def test_window_starts(n, window, stride, want):
    got = tsm.unified_window_starts(n, window, stride)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsm.unified_window_starts(n, window, stride))


def test_config_carries_across(world):
    jcfg = world[2]
    cfg = from_reference_config(jcfg)
    assert cfg == port_cfg()
    assert isinstance(cfg, tsm.SmootherConfig) and isinstance(cfg.pipe.klt, KLTConfig)


def test_track_tables_match_jax(world, monkeypatch):
    ls, rs, jcfg, _, starts, jobs, jmask, jiters = world
    cfg = from_reference_config(jcfg)
    iters = []
    real_klt = tsm.fe.klt_track

    def recording_klt(*args, **kwargs):
        res = real_klt(*args, **kwargs)
        iters.append(res.n_iter.numpy())
        return res

    monkeypatch.setattr(tsm.fe, "klt_track", recording_klt)
    obs, mask = (x.numpy() for x in tsm._build_window_tracks(
        torch.from_numpy(ls).float(), torch.from_numpy(rs).float(), starts, cfg))
    np.testing.assert_array_equal(np.stack(iters, axis=1), jiters)
    # the same tables in float64 (K1 takes float32 only: its plain version
    # is what the wrapper runs on the CPU)
    monkeypatch.setattr(tim, "gather_tiles", kg.gather_tiles_plain)
    obs64, mask64 = (x.numpy() for x in tsm._build_window_tracks(
        torch.from_numpy(ls).double(), torch.from_numpy(rs).double(), starts, cfg))

    assert obs.shape == jobs.shape == (2, 5, 256, 4) and mask.shape == jmask.shape
    assert (mask == jmask).mean() >= 0.98
    both = mask & jmask & mask64
    assert both.sum() > 1000
    err = np.abs(obs - jobs).max(axis=-1)[both]  # px, per observation
    jax_err = np.abs(jobs - obs64).max(axis=-1)[both]  # JAX's float32 rounding
    port_err = np.abs(obs - obs64).max(axis=-1)[both]
    sensitive = jax_err > 1e-3
    assert sensitive.mean() <= 0.005
    assert err[~sensitive].max() <= 1e-3, np.sort(err[~sensitive])[-5:]
    assert np.all(port_err[sensitive] <= jax_err[sensitive] + 1e-3)
    assert err.max() <= jcfg.pipe.klt.converge_px


@pytest.fixture(scope="module")
def port_scan(world):
    """The port's scan of the 9-frame world with JAX's samples, and the
    (batch, tile_h, tile_w) of every K1 call it made."""
    ls, rs, jcfg, *_ = world
    gathers = []
    real = tim.gather_tiles

    def recording(img, anchors, tile_h, tile_w):
        gathers.append((int(np.prod(img.shape[:-2])), tile_h, tile_w))
        return real(img, anchors, tile_h, tile_w)

    tim.gather_tiles = recording
    try:
        got = tsm.unified_system_scan(torch.from_numpy(ls), torch.from_numpy(rs),
                                      jax_sampler(jcfg.pipe, seed=1),
                                      from_reference_config(jcfg), wchunk=2)
    finally:
        tim.gather_tiles = real
    return got, gathers


def test_unified_scan_matches_jax_with_injected_samples(world, port_scan):
    _, _, jcfg, want, *_ = world
    got = port_scan[0]
    np.testing.assert_array_equal(got.vo_success, want.vo_success)
    assert want.vo_success.all() and got.ba_converged.all()
    for name in ("vo_motions", "refined_motions"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[..., :3, :3], b[..., :3, :3], atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a[..., :3, 3], b[..., :3, 3], atol=1e-3, err_msg=name)
    assert np.all(np.abs(got.n_frame_obs - want.n_frame_obs) <= 0.02 * 256)
    # covariances ([dt, dtheta] tangent; BA's in the window's frame-0 gauge)
    for name in ("vo_cov", "cam_cov", "ba_motion_cov"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape and np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max(), err_msg=name)
    # and the per-frame pose covariances the host composes from them
    mine = tsm.compose_unified(got, N_JAX, from_reference_config(jcfg))
    ref = jsm.compose_unified(want, N_JAX, jcfg)
    for name in ("motion_cov", "pose_cov"):
        b = getattr(ref, name)
        np.testing.assert_allclose(getattr(mine, name), b, rtol=0, atol=1e-3 * np.abs(b).max(),
                                   err_msg=name)


def test_group_gathers_at_the_checked_shapes(port_scan):
    """One group (2 windows) of the scan makes ``chip_smoke.K1_PER_GROUP``
    tile gathers, all at the group's batch and at tile shapes that
    ``chip_smoke.py`` holds against the plain version."""
    smoke = load_module("chip_smoke.py")
    gathers = port_scan[1]
    assert len(gathers) == smoke.K1_PER_GROUP == 52
    assert {b for b, *_ in gathers} == {2}
    assert {tuple(t) for _, *t in gathers} == set(smoke.SHAPES)


def test_composer_matches_jax(world):
    _, _, jcfg, out, starts, *_ = world
    want = jsm.compose_unified(out, N_JAX, jcfg)
    host = tsm.UnifiedOutput(*(np.asarray(x) for x in out))
    got = tsm._compose_from_chunks([(host, starts, N_JAX)], N_JAX, from_reference_config(jcfg))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(chain_covariances_np(got.traj_ba[1:], got.motion_cov),
                               jax_chain(got.traj_ba[1:], got.motion_cov), rtol=0, atol=1e-12)


def test_uncovered_stride_refused_by_both_engines():
    cfg = port_cfg(ba_rate=5)  # window 5: motion 4 of each period uncovered
    ls = torch.zeros((12, 192, 320), dtype=torch.uint8)
    with pytest.raises(ValueError, match="ba_rate"):
        tsm.unified_system_scan(ls, ls, None, cfg)
    with pytest.raises(ValueError, match="ba_rate"):
        tsm.run_unified_streaming(iter([]), cfg, device="cpu")


@pytest.fixture(scope="module")
def streams():
    """22 frames: the staged engine, the streaming engine in super-chunks of
    2 windows (advance 8 frames), and that run split at frame 8 and merged."""
    seq, frames = render(22)
    cfg = port_cfg()
    kw = dict(seed=1, wchunk=2, device="cpu")
    whole = tsm.run_unified_system(frames, cfg, **kw)
    stats: dict = {}
    stream = tsm.run_unified_streaming(iter(frames), cfg, groups=1, stats=stats, **kw)
    part_a = tsm.run_unified_streaming(iter(frames[:9]), cfg, groups=1, **kw)
    part_b = tsm.run_unified_streaming(iter(frames[8:]), cfg, groups=1, start_frame=8, **kw)
    return seq, whole, stream, stats, tsm.merge_unified_results(part_a, part_b, at=8)


def test_streaming_matches_staged(streams):
    seq, whole, stream, stats, _ = streams
    assert stream.traj_ba.shape == whole.traj_ba.shape == (22, 4, 4)
    # motions 0-15 have the same covering windows in both engines (their
    # tails differ: the staged scan's clamped window against the streaming
    # grid's padded one)
    for name in ("traj_vo", "traj_ba"):
        np.testing.assert_allclose(getattr(stream, name)[:17], getattr(whole, name)[:17],
                                   atol=1e-4, err_msg=name)
    assert stats["upload_s"] and len(stats["upload_bytes"]) == 3
    assert metrics.ate_rmse(stream.traj_ba[:, :3, 3], seq.gt_positions()) < 0.1


def test_streaming_resume_merge_matches_unbroken(streams):
    _, _, stream, _, merged = streams
    assert merged.traj_vo.shape == stream.traj_vo.shape
    np.testing.assert_allclose(merged.traj_vo, stream.traj_vo, atol=1e-5)
    np.testing.assert_allclose(merged.traj_ba, stream.traj_ba, atol=1e-5)
    np.testing.assert_array_equal(merged.per_frame[:, 16], stream.per_frame[:, 16])
    np.testing.assert_array_equal(merged.ba_converged, stream.ba_converged)


def test_own_sampler_clean_world_ba_lowers_ate():
    seq, frames = render(17)
    res = tsm.run_unified_system(frames, port_cfg(), seed=1, device="cpu")
    gt = seq.gt_positions()
    assert res.traj_ba.shape == (17, 4, 4)
    assert res.ba_converged.all() and np.all(res.per_frame[:, 16] > 0.5)
    ate_vo = metrics.ate_rmse(res.traj_vo[:, :3, 3], gt)
    ate_ba = metrics.ate_rmse(res.traj_ba[:, :3, 3], gt)
    assert ate_ba < ate_vo, (ate_vo, ate_ba)
    # the covariance circuit: installed-motion covariances chained per frame
    assert res.motion_cov.shape == (16, 6, 6) and res.pose_cov.shape == (17, 6, 6)
    assert np.isfinite(res.pose_cov).all() and np.trace(res.pose_cov[0]) == 0.0
    tr = np.trace(res.pose_cov, axis1=1, axis2=2)
    assert (tr[1:] > 0).all() and tr[-1] > tr[1]
