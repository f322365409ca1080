"""The port's parallel layer (``parallel/``) in 4 gloo ranks on the CPU.

One ``run_ranks`` launch of 4 ranks (module fixture) runs every sharded
entry point; the tests read its results:

- ``sharded_chain_motions`` on 64 random motions (16 a rank), and
  ``chain_motions`` in one process, against JAX's ``chain_motions`` within
  1e-5 and against the serial float64 chain within 1e-4
  (tests/test_parallel.py:51);
- ``window_parallel_ba`` on the graft's phase-3 problem (4 windows of 4
  frames, ``n_fixed`` 2, 64 points, one window a rank, 4 sweeps) against
  JAX's ``window_parallel_ba`` on a 4-device ``make_mesh(4)`` of the
  conftest's CPU devices, cameras within 1e-4; and on
  tests/test_parallel_ba.py's problem (4 windows of 6 frames, 0.1 px noise,
  perturbed start, 3 sweeps): shared frames within 5e-4, every window
  within 5e-3 of the truth. Without the exchange (plain batched
  ``ba_solve``) the boundaries stay more than 2e-3 apart;
- ``sharded_sequence_vo`` at 96x160 (8 pairs, 2 a rank, RANSAC seed 0)
  against the port's single-process staged engine with the same sampler,
  poses within 5e-4 (tests/test_parallel.py:109-111), every pair solved,
  covariances finite, symmetric, trace < 1e-2, positions within 0.25 m of
  the truth;
- ``sharded_unified_scan`` at 96x160 (34 frames: 9 windows padded to 12, 3
  a rank) against the port's ``unified_system_scan`` in one process:
  ``vo_motions`` within 1e-3, ``refined_motions`` within 1e-2, composed ATE
  < 0.15 m (tests/test_parallel.py:265-312).

The sharded VO and unified engines are held to the port's own twins, which
the other test files hold to JAX; JAX's sharded engines are not compiled
here. Rank bodies live at module level (the ranks import this module), and
JAX is imported only inside the fixtures that compare with it.
"""

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch import parallel
from uasl_motion_estimation_tpu_torch.models.pipeline import (
    OdometryPipeline, default_config, make_sampler)
from uasl_motion_estimation_tpu_torch.models.smoother import (
    SmootherConfig, compose_unified, unified_system_scan)
from uasl_motion_estimation_tpu_torch.ops import lie
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
from uasl_motion_estimation_tpu_torch.parallel import launch
from uasl_motion_estimation_tpu_torch.parallel.ba_windows import shard_windows, window_parallel_ba
from uasl_motion_estimation_tpu_torch.solvers.ba import BAConfig, BAProblem, ba_solve
from uasl_motion_estimation_tpu_torch.utils import metrics, synthetic

torch.set_num_threads(1)
RANKS = 4
RIG = synthetic.CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5, height=96,
                          width=160)
N_PAIRS = 8
N_UNIFIED = 34  # 8 aligned windows of 5 at stride 4 and the clamped tail (29)


def random_motions(n, seed=11):
    rng = np.random.default_rng(seed)
    ms = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rot = lie.so3_exp(torch.from_numpy(rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)))
    ms[:, :3, :3] = rot.numpy()
    ms[:, :3, 3] = rng.normal(scale=0.5, size=(n, 3))
    return ms


def serial_chain(motions):
    pose = np.eye(4)
    out = []
    for m in np.asarray(motions, np.float64):
        pose = pose @ np.linalg.inv(m)
        out.append(pose.copy())
    return np.stack(out)


def graft_problem():
    """The graft's phase-3 problem for 4 devices: 4 windows of 4 frames,
    n_fixed 2, 64 points, every window perturbed but window 0's head."""
    intr = Intrinsics(200.0, 200.0, 80.0, 48.0)
    _, _, prob = synthetic.stereo_ba_windows(np.random.default_rng(3), intr, 0.5, 10, 64, 4, 2,
                                             0.0)
    prob = BAProblem(*prob)
    wc, _ = synthetic.perturb_windows(prob.cam, prob.pts, np.random.default_rng(3), 2,
                                      pts_sigma=0)
    return prob._replace(cam=wc), BAConfig(intr=intr, baseline=0.5, n_fixed=2)


def halo_problem(seed, perturb_seed, perturb_pts=True):
    """tests/test_parallel_ba.py's problem: 18 frames, 4 windows of 6
    overlapping by 2, 0.1 px noise, cameras (window 0's head kept) and, with
    ``perturb_pts``, points perturbed."""
    intr = Intrinsics(400.0, 400.0, 320.0, 240.0)
    cams, starts, prob = synthetic.stereo_ba_windows(np.random.default_rng(seed), intr, 0.5, 18,
                                                     100, 6, 2, 0.1, image_shape=(480, 640))
    prob = BAProblem(*prob)
    wc, wp = synthetic.perturb_windows(prob.cam, prob.pts, np.random.default_rng(perturb_seed),
                                       2, pts_sigma=0.3 if perturb_pts else 0)
    return cams, starts, prob._replace(cam=wc, pts=wp), BAConfig(intr=intr, baseline=0.5,
                                                                 n_fixed=2)


def vo_config():
    return default_config(Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv), RIG.baseline
                          )._replace(max_features=192)


def unified_config():
    pipe = default_config(Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv), RIG.baseline,
                          image_shape=(RIG.height, RIG.width))._replace(max_features=128)
    return SmootherConfig(pipe=pipe)


def u8_stacks(frames):
    return tuple(np.clip(np.stack([f[k] for f in frames]), 0, 255).astype(np.uint8)
                 for k in (0, 1))


def rank_body(mesh, motions, vo_ls, vo_rs, uni_ls, uni_rs):
    """Every sharded entry point on this rank's shard; numpy results."""
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    out["chain"] = parallel.sharded_chain_motions(parallel.shard_frames(motions, mesh),
                                                  mesh).numpy()

    prob, cfg = graft_problem()
    out["graft_ba"] = window_parallel_ba(shard_windows(prob, mesh), cfg, mesh,
                                         n_sweeps=RANKS).cam.numpy()
    _, _, prob, cfg = halo_problem(1, 5)
    out["halo_ba"] = window_parallel_ba(shard_windows(prob, mesh), cfg, mesh, n_sweeps=3
                                        ).cam.numpy()

    cfg = vo_config()
    sampler = make_sampler(0, cfg.vo.n_ransac)
    poses, success, n_inl, cov = parallel.sharded_sequence_vo(
        *(parallel.shard_frames(x, mesh) for x in (vo_ls[:-1], vo_rs[:-1], vo_ls[1:],
                                                   vo_rs[1:])), sampler, cfg, mesh)
    out["vo"] = tuple(x.numpy() for x in (poses, success, n_inl, cov))

    ucfg = unified_config()
    uni = parallel.sharded_unified_scan(uni_ls, uni_rs, make_sampler(0, ucfg.pipe.vo.n_ransac),
                                        ucfg, mesh)
    out["unified"] = uni._asdict()
    out["counts"] = dict(mesh.counts)
    return out


def failing_body(mesh):
    if mesh.rank == 2:
        raise ValueError("rank 2 gives up")
    return mesh.rank


@pytest.fixture(scope="module")
def ranks():
    vo_seq = synthetic.SyntheticStereoSequence(n_frames=N_PAIRS + 1, rig=RIG, seed=6)
    vo_frames = [vo_seq.frame(i) for i in range(N_PAIRS + 1)]
    uni_seq = synthetic.SyntheticStereoSequence(n_frames=N_UNIFIED, rig=RIG, seed=6)
    uni_frames = [uni_seq.frame(i) for i in range(N_UNIFIED)]
    vo_ls, vo_rs = u8_stacks(vo_frames)
    uni_ls, uni_rs = u8_stacks(uni_frames)
    motions = random_motions(64)
    outs = launch.run_ranks(rank_body, RANKS, "gloo", "cpu", motions, vo_ls, vo_rs, uni_ls,
                            uni_rs)
    return {"outs": outs, "motions": motions, "vo": (vo_seq, vo_ls, vo_rs),
            "unified": (uni_seq, uni_ls, uni_rs)}


def test_ranks_run_on_the_cpu_and_exchange(ranks):
    outs = ranks["outs"]
    assert [o["rank"] for o in outs] == list(range(RANKS))
    assert all(o["device"] == "cpu" for o in outs)
    # chain and unified gather once each; VO's chain gathers once; BA sends
    # once per sweep (4 + 3) on every rank but the last, receives on all but 0
    for o in outs:
        assert o["counts"] == {"all_gather": 3, "p2p": 7}, o["counts"]


def test_chain_matches_jax_and_serial(ranks):
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu import parallel as jpar

    motions = ranks["motions"]
    sharded = np.concatenate([o["chain"] for o in ranks["outs"]])
    single = parallel.chain_motions(torch.from_numpy(motions)).numpy()
    want = np.asarray(jpar.chain_motions(jnp.asarray(motions)))
    np.testing.assert_allclose(single, want, atol=1e-5)
    np.testing.assert_allclose(sharded, want, atol=1e-5)
    np.testing.assert_allclose(sharded, serial_chain(motions), atol=1e-4)


def test_window_ba_matches_jax_mesh(ranks):
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu import parallel as jpar
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics as JaxIntrinsics
    from uasl_motion_estimation_tpu.parallel.ba_windows import shard_windows as jshard
    from uasl_motion_estimation_tpu.parallel.ba_windows import window_parallel_ba as jwpba
    from uasl_motion_estimation_tpu.solvers.ba import BAConfig as JaxBAConfig
    from uasl_motion_estimation_tpu.solvers.ba import BAProblem as JaxBAProblem

    assert jax.device_count() >= RANKS, "conftest must provide the CPU devices"
    prob, cfg = graft_problem()
    mesh = jpar.make_mesh(RANKS)
    jcfg = JaxBAConfig(intr=JaxIntrinsics(*cfg.intr), baseline=cfg.baseline, n_fixed=cfg.n_fixed)
    want = np.asarray(jwpba(jshard(JaxBAProblem(*map(jnp.asarray, prob)), mesh), jcfg, mesh,
                            n_sweeps=RANKS).cam)
    got = np.concatenate([o["graft_ba"] for o in ranks["outs"]])
    np.testing.assert_allclose(got, want, atol=1e-4)
    halo = max(np.abs(got[i, -2:] - got[i + 1, :2]).max() for i in range(RANKS - 1))
    assert halo < 5e-4, halo


def test_halo_exchange_consistent_chain(ranks):
    cams, starts, _, _ = halo_problem(1, 5)
    out = np.concatenate([o["halo_ba"] for o in ranks["outs"]])
    for i in range(len(starts) - 1):
        np.testing.assert_allclose(out[i, -2:], out[i + 1, :2], atol=5e-4,
                                   err_msg=f"boundary {i} inconsistent")
    for i, s in enumerate(starts):
        np.testing.assert_allclose(out[i], cams[s:s + 6], atol=5e-3,
                                   err_msg=f"window {i} diverged")


def test_uncoupled_windows_drift_apart():
    _, starts, prob, cfg = halo_problem(2, 6, perturb_pts=False)
    res = ba_solve(BAProblem(*map(torch.from_numpy, prob)), cfg)
    out = res.cam.numpy()
    worst = max(np.abs(out[i, -2:] - out[i + 1, :2]).max() for i in range(len(starts) - 1))
    assert worst > 2e-3, f"expected inconsistency, got {worst}"


def test_sharded_sequence_vo_matches_single_process(ranks):
    seq, ls, rs = ranks["vo"]
    poses, success, n_inl, cov = (np.concatenate([o["vo"][k] for o in ranks["outs"]])
                                  for k in range(4))
    assert success.all(), n_inl
    assert cov.shape == (N_PAIRS, 6, 6) and np.isfinite(cov).all()
    np.testing.assert_allclose(cov, np.swapaxes(cov, 1, 2), atol=1e-8)
    assert (np.trace(cov, axis1=1, axis2=2) < 1e-2).all()
    est = np.concatenate([np.zeros((1, 3)), poses[:, :3, 3]])
    gt = seq.gt_positions() - seq.gt_positions()[0]
    assert np.linalg.norm(est - gt, axis=-1).max() < 0.25
    pipe = OdometryPipeline(vo_config(), seed=0, device="cpu")
    twin = pipe.run_staged(torch.from_numpy(ls), torch.from_numpy(rs), chunk=N_PAIRS)
    np.testing.assert_allclose(poses, twin[1:], atol=5e-4)


def test_sharded_unified_matches_single_process(ranks):
    seq, ls, rs = ranks["unified"]
    cfg = unified_config()
    sharded = ranks["outs"][0]["unified"]
    for o in ranks["outs"][1:]:  # every rank holds the whole gathered output
        for k, v in o["unified"].items():
            np.testing.assert_array_equal(v, sharded[k])
    single = unified_system_scan(torch.from_numpy(ls), torch.from_numpy(rs),
                                 make_sampler(0, cfg.pipe.vo.n_ransac), cfg, wchunk=3)
    assert sharded["vo_motions"].shape == single.vo_motions.shape == (9, 4, 4, 4)
    np.testing.assert_allclose(sharded["vo_motions"], single.vo_motions, atol=1e-3)
    np.testing.assert_allclose(sharded["refined_motions"], single.refined_motions, atol=1e-2)
    res = compose_unified(type(single)(**sharded), N_UNIFIED, cfg)
    assert res.ba_converged.all()
    assert metrics.ate_rmse(res.traj_ba[:, :3, 3], seq.gt_positions()) < 0.15


def test_failed_rank_raises_in_the_caller():
    with pytest.raises(RuntimeError, match=r"(?s)rank 2 of 4 failed.*rank 2 gives up"):
        launch.run_ranks(failing_body, RANKS, "gloo", "cpu")


def test_mesh_refuses_what_it_cannot_have(tmp_path):
    with pytest.raises(RuntimeError, match="initialised process group"):
        launch.make_mesh(device="cpu")
    with launch.process_group("gloo", 1, 0, tmp_path / "store"):
        with pytest.raises(ValueError, match="mesh of 2 ranks"):
            launch.make_mesh(2, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA card"):
                launch.make_mesh()
        mesh = launch.make_mesh(1, device="cpu")
        # one rank: the chain is chain_motions, and nothing is sent
        motions = torch.from_numpy(random_motions(5))
        torch.testing.assert_close(parallel.sharded_chain_motions(motions, mesh),
                                   parallel.chain_motions(motions), rtol=0, atol=0)
        x = torch.ones(2, 6)
        assert torch.equal(launch.send_to_next(mesh, x), torch.zeros(2, 6))
        assert mesh.counts == {"all_gather": 1, "p2p": 0}
        two = launch.Mesh(0, 2, torch.device("cpu"), "gloo", {})
        with pytest.raises(ValueError, match="do not divide"):
            parallel.shard_frames(np.zeros((3, 2)), two)
