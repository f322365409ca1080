"""The port's latency mode (``models/odometry.py``) against the JAX
reference, on the 192x320 rig of ``tests/test_odometry.py`` with 256 tracks
and 96 disparities.

The JAX reference runs once (module fixture): ``OdometrySystem`` with
``parallax=2.0`` and BA, RANSAC seed 1, on a 14-frame ``near_stop`` world,
where the gate holds keyframes through the stop and BA runs on the window.
Its RANSAC draws are the Gumbel orders of its own key chain (one split per
frame after the first), fed to the port through the ``sampler`` seam: the
first 3 valid slots of each hypothesis's order, which is what JAX's
``_sample_hypotheses`` picks on the same valid mask.

Held to JAX (tolerances as stated per test): ``bootstrap_frame`` and
``track_and_solve`` (equal masks and ids, uv within 1e-3 px, motion within
1e-4), ``ba_refine_window`` on JAX's table and cameras (cameras within
1e-4), the ``cam6`` conversions, and the whole loop (every pose within
1e-3 m, the same keyframe decisions). Port only: BA lowers the ATE below
0.95x the VO-only chain's (JAX's own ``test_ba_refinement_improves_ate``),
the building blocks give the same result unbatched as with a leading batch
of 1, and ``OdometrySystem`` raises without a card unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu.models import odometry as jodo
from uasl_motion_estimation_tpu.models.frontend import MatcherConfig as JaxMatcherConfig
from uasl_motion_estimation_tpu.models.stereo_vo import StereoVOParams as JaxVOParams
from uasl_motion_estimation_tpu.ops.geometry import Intrinsics as JaxIntrinsics
from uasl_motion_estimation_tpu_torch.config import from_reference_config
from uasl_motion_estimation_tpu_torch.models import frontend as tfe
from uasl_motion_estimation_tpu_torch.models import odometry as todo
from uasl_motion_estimation_tpu_torch.models import stereo_vo as tvo
from uasl_motion_estimation_tpu_torch.models import tracks as ttr
from uasl_motion_estimation_tpu_torch.ops import image as tim
from uasl_motion_estimation_tpu_torch.ops.kernels import gather as kg
from uasl_motion_estimation_tpu_torch.solvers import ba as tba
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)
RIG = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=192, width=320)
N = 14
SEED = 1


def jax_cfg(**over):
    intr = JaxIntrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv)
    base = dict(vo=JaxVOParams(intr1=intr, intr2=intr, baseline=RIG.baseline), max_tracks=256,
                window=5, ba_rate=5, matcher=JaxMatcherConfig(max_disparity=96))
    base.update(over)
    return jodo.OdometryConfig(**base)


JCFG = jax_cfg(parallax=2.0)
TCFG = from_reference_config(JCFG)


def jax_orders(key, cfg):
    """(H, M) slot orders by descending Gumbel noise of ``key``'s draws."""
    g = jax.vmap(lambda k: jax.random.gumbel(k, (cfg.max_tracks,)))(
        jax.random.split(key, cfg.vo.n_ransac))
    return np.asarray(jnp.argsort(-g, axis=-1, stable=True))


def orders_sampler(orders: np.ndarray):
    """The sampler seam fed JAX's draws: (steps, H, M) orders; a hypothesis
    takes the first 3 valid slots of its order."""
    orders_t = torch.from_numpy(orders.astype(np.int64))

    def sample(step: int, valid: torch.Tensor) -> torch.Tensor:
        perm = orders_t[step]
        first = torch.argsort((~valid[perm]).to(torch.int8), dim=-1, stable=True)[:, :3]
        return torch.gather(perm, 1, first)

    return sample


def table_from_jax(t) -> ttr.TrackTable:
    return ttr.TrackTable(*(torch.from_numpy(np.array(x)) for x in t))


def plain_gather(img, anchors, tile_h, tile_w):
    """K1's plain version for any dtype and leading dims (the wrapper, like
    the kernel, takes float32 only)."""
    h, w = img.shape[-2:]
    n = anchors.shape[-2]
    out = kg.gather_tiles_plain(img.reshape(-1, h, w), anchors.reshape(-1, n, 2), tile_h, tile_w)
    return out.reshape(*anchors.shape[:-2], n, tile_h, tile_w)


def assert_tables_equal(got: ttr.TrackTable, want, got64: ttr.TrackTable):
    """Equal masks, ids and counters; uv within 1e-3 px of JAX's, except
    where float32 rounding alone moves an answer that far: the 1-D
    Lucas-Kanade polish of match_stereo amplifies it on weak texture, so
    that JAX's and the port's float32 answers may lie on either side of the
    float64 one (the port's, run on the same inputs). At most 3 % of the
    observations may differ from JAX's by more than 1e-3 px, and each of
    them must lie within 2e-3 px of the float64 answer, or no farther from
    it than JAX's answer plus 1e-3 px."""
    for name in ("obs_mask", "active", "track_id", "pt3d_valid", "next_id", "n_frames"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    obs = got.obs_mask.numpy() & got64.obs_mask.numpy()
    assert obs.sum() > 100
    uv, juv, uv64 = got.uv.numpy(), np.asarray(want.uv), got64.uv.numpy()
    err = np.abs(uv - juv).max(axis=-1)[obs]
    port_err = np.abs(uv - uv64).max(axis=-1)[obs]
    jax_err = np.abs(juv - uv64).max(axis=-1)[obs]
    apart = err > 1e-3
    assert apart.mean() <= 0.03, np.sort(err)[-8:]
    assert np.all(port_err[apart] <= np.maximum(jax_err[apart], 1e-3) + 1e-3), (
        port_err[apart], jax_err[apart])


@pytest.fixture(scope="module")
def world():
    seq = synthetic.SyntheticStereoSequence(
        n_frames=N, rig=RIG, seed=7, trajectory=synthetic.stress_trajectory("near_stop", N))
    return seq, [seq.frame(i) for i in range(N)]


@pytest.fixture(scope="module")
def jax_run(world):
    """JAX's whole loop frame by frame: its records, its trajectory after
    each frame, each step's motion, its draws (keys and Gumbel orders) and
    its final state."""
    _, frames = world
    log = jodo.MetricsLogger()
    system = jodo.OdometrySystem(JCFG, seed=SEED, logger=log, use_ba=True)
    real, motions = jodo.track_and_solve, []

    def recording(*args):
        out = real(*args)
        motions.append(np.asarray(out.motion))
        return out

    snapshots = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jodo, "track_and_solve", recording)
        for f in frames:
            system.process_pair(*f)
            snapshots.append(np.asarray(system.trajectory))
    key, keys = jax.random.key(SEED), []
    for _ in range(N - 1):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return {"snapshots": snapshots, "records": log.records, "keys": keys, "motions": motions,
            "orders": np.stack([jax_orders(k, JCFG) for k in keys]), "system": system}


def f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def f64(x):
    return torch.from_numpy(np.asarray(x, np.float32).astype(np.float64))


def test_bootstrap_frame_matches_jax(world, monkeypatch):
    """The first pair's table, held as ``assert_tables_equal`` says."""
    _, frames = world
    want = jodo.bootstrap_frame(jnp.asarray(frames[0][0], jnp.float32),
                                jnp.asarray(frames[0][1], jnp.float32), JCFG)
    got = todo.bootstrap_frame(f32(frames[0][0]), f32(frames[0][1]), TCFG)
    monkeypatch.setattr(tim, "gather_tiles", plain_gather)
    got64 = todo.bootstrap_frame(f64(frames[0][0]), f64(frames[0][1]), TCFG)
    assert int(got.active.sum()) > 150
    assert_tables_equal(got, want, got64)


@pytest.mark.parametrize("frame", [1, 6])
def test_track_and_solve_matches_jax(world, frame, monkeypatch):
    """One step from JAX's bootstrap table (frame 1) and from a table two
    steps on (frame 6, in the stop), with JAX's draws: the new table held as
    ``assert_tables_equal`` says, motion within 1e-4, equal counts, the
    median flow within 1e-3 px."""
    _, frames = world
    jl = [jnp.asarray(f[0], jnp.float32) for f in frames]
    jr = [jnp.asarray(f[1], jnp.float32) for f in frames]
    prev = frame - 1
    first = max(0, frame - 3)  # JAX's table: bootstrapped, then tracked to prev
    table = jodo.bootstrap_frame(jl[first], jr[first], JCFG)
    for f in range(first + 1, frame):
        table = jodo.track_and_solve(table, jl[f - 1], jl[f], jr[f], jax.random.key(100 + f),
                                     JCFG).table
    key = jax.random.key(200 + frame)
    want = jodo.track_and_solve(table, jl[prev], jl[frame], jr[frame], key, JCFG)
    sampler = orders_sampler(jax_orders(key, JCFG)[None])
    got = todo.track_and_solve(table_from_jax(table), f32(frames[prev][0]),
                               f32(frames[frame][0]), f32(frames[frame][1]), 0, sampler, TCFG)
    monkeypatch.setattr(tim, "gather_tiles", plain_gather)
    got64 = todo.track_and_solve(
        ttr.TrackTable(*(x.double() if x.is_floating_point() else x
                         for x in table_from_jax(table))),
        f64(frames[prev][0]), f64(frames[frame][0]), f64(frames[frame][1]), 0, sampler,
        TCFG)
    assert bool(got.success) and bool(want.success)
    assert_tables_equal(got.table, want.table, got64.table)
    for name in ("n_matches", "n_inliers", "n_tracks"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(want.motion), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.median_flow), float(want.median_flow), atol=1e-3)


def test_ba_refine_window_matches_jax(jax_run):
    """BA on JAX's last table with cameras from JAX's window poses: the
    cam6 conversions equal JAX's within 1e-6, the refined cameras within
    1e-4, the cost within 1e-3 relative."""
    system = jax_run["system"]
    base = system.window_poses[0]
    T = np.stack([np.linalg.inv(p) @ base for p in system.window_poses])
    want_cams = np.stack([jodo.cam6_from_pose(t) for t in T])
    cams = todo.cam6_from_pose(T)
    np.testing.assert_allclose(cams.numpy(), want_cams, rtol=0, atol=1e-6)
    np.testing.assert_allclose(todo.pose_from_cam6(cams).numpy(),
                               np.stack([jodo.pose_from_cam6(c) for c in want_cams]),
                               rtol=0, atol=1e-6)
    want = jodo.ba_refine_window(system.table, jnp.asarray(want_cams), JCFG)
    got = todo.ba_refine_window(table_from_jax(system.table), f32(want_cams), TCFG)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3)


def test_whole_loop_matches_jax_with_its_draws(world, jax_run, monkeypatch):
    """14 frames, parallax gate 2 px, BA every 5 keyframes, JAX's draws.

    Every frame: the same keyframe decision, success and BA schedule, and
    JAX's ``track_and_solve`` given the port's own inputs of that step (its
    table and keyframe image) gives the port's motion within 1e-4. The
    trajectory, frame by frame: every pose within 1e-3 m (translation) and
    1e-4 (rotation entries) of JAX's after the same frame, up to the step
    where float32 rounding of the two tables (uv within 5e-3 px after 13
    frames, under KLT's 0.03 px stopping step) tips JAX's own RANSAC vote
    to another inlier set of the same size: on this world that is the last
    step (frame 13). The witness is asserted there: JAX's step on JAX's own
    table and on the port's gives motions more than 1e-2 m apart, while the
    port's motion is JAX's on the port's table (above). The loop must agree
    before that step."""
    seq, frames = world
    steps = []
    real = todo.track_and_solve

    def recording(table, prev_left, cur_left, cur_right, step, sampler, cfg):
        out = real(table, prev_left, cur_left, cur_right, step, sampler, cfg)
        steps.append((table, prev_left, cur_left, cur_right, step, out.motion))
        return out

    monkeypatch.setattr(todo, "track_and_solve", recording)
    log = metrics.MetricsLogger()
    system = todo.OdometrySystem(TCFG, seed=SEED, logger=log, use_ba=True, device="cpu",
                                 sampler=orders_sampler(jax_run["orders"]))
    snapshots = []
    for f in frames:
        system.process_pair(*f)
        snapshots.append(np.asarray(system.trajectory))
    want = jax_run["records"]
    for key in ("keyframe", "success", "n_matches", "n_inliers"):
        assert [r.get(key) for r in log.records] == [r.get(key) for r in want], key
    assert ["ba_cost" in r for r in log.records] == ["ba_cost" in r for r in want]
    assert any("ba_cost" in r for r in want)
    n_kf = system.n_keyframes
    assert n_kf == jax_run["system"].n_keyframes and n_kf < N

    assert len(steps) == N - 1 == len(jax_run["motions"])
    jax_on_port = []
    for table, prev_left, cur_left, cur_right, step, motion in steps:
        j = jodo.track_and_solve(jodo.tr.TrackTable(*(jnp.asarray(x.numpy()) for x in table)),
                                 *(jnp.asarray(x.numpy()) for x in (prev_left, cur_left,
                                                                    cur_right)),
                                 jax_run["keys"][step], JCFG)
        np.testing.assert_allclose(motion.numpy(), np.asarray(j.motion), rtol=0, atol=1e-4,
                                   err_msg=f"step {step}")
        jax_on_port.append(np.asarray(j.motion))

    def apart(a, b):
        return np.abs(a[:, :3, 3] - b[:, :3, 3]).max() > 1e-3

    first = next((f for f, (a, b) in enumerate(zip(snapshots, jax_run["snapshots"]))
                  if apart(a, b)), N)
    assert first >= N - 1, first
    if first < N:  # the witness: JAX's own vote tips between the two tables
        gap = np.abs(jax_run["motions"][first - 1][:3, 3] - jax_on_port[first - 1][:3, 3]).max()
        assert gap > 1e-2, gap
    for a, b in zip(snapshots[:first], jax_run["snapshots"][:first]):
        np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], rtol=0, atol=1e-4)
    ate = metrics.ate_rmse(snapshots[-1][:, :3, 3], seq.gt_positions())
    assert ate < 0.05, ate


def test_ba_lowers_ate():
    """JAX's test_ba_refinement_improves_ate on the port: the seed-4 world,
    RANSAC seed 1, the port's own draws."""
    seq = synthetic.SyntheticStereoSequence(n_frames=N, rig=RIG, seed=4)
    frames = [seq.frame(i) for i in range(N)]
    cfg = from_reference_config(jax_cfg())
    gt = seq.gt_positions()
    ates = {}
    for use_ba in (False, True):
        traj = todo.OdometrySystem(cfg, seed=SEED, use_ba=use_ba, device="cpu").run(frames)
        assert traj.shape == (N, 4, 4)
        ates[use_ba] = metrics.ate_rmse(traj[:, :3, 3], gt)
    dist = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert ates[False] < 0.02 * dist, ates
    assert ates[True] < 0.95 * ates[False], ates


def test_unbatched_equals_batch_of_one(world):
    """track_and_solve and ba_refine_window call the batched klt_track,
    match_stereo, stereo_vo_solve and ba_solve with no leading dim: each
    equals its call with a leading batch of 1 at those shapes, exactly, and
    ba_solve within 1e-4 relative (its far points, 100+ m deep, move most)
    and 1e-6 absolute."""
    _, frames = world
    l0, r0, l1, r1 = (f32(x) for x in (*frames[0], *frames[1]))
    table = todo.bootstrap_frame(l0, r0, TCFG)
    uv, ok = ttr.latest_uv(table)
    kl = tfe.klt_track(l0, l1, uv[:, :2], ok, TCFG.klt)
    kb = tfe.klt_track(l0[None], l1[None], uv[None, :, :2], ok[None], TCFG.klt)
    for a, b in zip(kl, kb):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)
    ms = tfe.match_stereo(l1, r1, kl.pts, kl.valid, TCFG.matcher)
    mb = tfe.match_stereo(l1[None], r1[None], kl.pts[None], kl.valid[None], TCFG.matcher)
    for a, b in zip(ms, mb):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)
    quad = torch.stack([uv[:, :2], uv[:, 2:], kl.pts, ms[0]], dim=1)
    valid = ok & kl.valid & ms[2]
    samples = tvo._sample_hypotheses(torch.Generator().manual_seed(0), TCFG.vo.n_ransac, valid)
    vs = tvo.stereo_vo_solve(quad, valid, None, TCFG.vo, samples=samples)
    vb = tvo.stereo_vo_solve(quad[None], valid[None], None, TCFG.vo, samples=samples[None])
    assert bool(vs.success)
    for a, b in zip(vs, vb):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)
    cams = torch.zeros(2, 6)
    cams[1, 3:] = vs.state[3:]
    pts = todo.geo.triangulate_disparity(uv[:, :2], uv[:, 2:], TCFG.vo.intr1, TCFG.vo.intr2,
                                         TCFG.vo.baseline)
    obs = torch.stack([uv, torch.cat([kl.pts, ms[0]], dim=-1)])
    mask = torch.stack([ok, valid])
    bcfg = todo._ba_config(TCFG)._replace(n_fixed=1, max_iter=5)
    bs = tba.ba_solve(tba.BAProblem(cams, pts, obs, mask), bcfg)
    bb = tba.ba_solve(tba.BAProblem(cams[None], pts[None], obs[None], mask[None]), bcfg)
    # the batched products of the Schur solve sum in another order
    for a, b in zip(bs, bb):
        torch.testing.assert_close(a, b[0], rtol=1e-4, atol=1e-6)


def test_entry_point_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        todo.OdometrySystem(TCFG)
    assert todo.OdometrySystem(TCFG, device="cpu").device.type == "cpu"
