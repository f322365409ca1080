"""Offline integrated VO+BA: ``flights`` recorded flights on the device
(the same drive through halls textured from the seed), and a pass is, for
each flight, one ``unified_system_scan(ls, rs, sampler, cfg, wchunk)`` then
``compose_unified``.

Traffic parameters: ``flights``, ``frames`` (a flight), ``wchunk`` (windows
a group), ``trace_passes``. The comparison judges one flight of one pass,
drawn from the seed, window by window:

- ``tracks_px``: the track tables, by the photometric steps the reference
  would still take from them (the median over valid observations of the
  larger of the KLT step from the track's previous frame and the stereo
  step to its right match);
- ``vo_solve_px``: every window's step motions and flags
  (``common.judge_steps``);
- ``ba_start_px``: each window's BA start (cameras chained from its VO
  motions, points, the track gate) against the reference's from the same
  motions and tracks: the largest camera gap or point gap in pixels, inf
  where a track's gate differs by more than 1e-3 px of rounding;
- ``ba_cost_rel``: each window's refined cost over the reference optimum
  of the same start, less one, or the reported cost's gap from the cost
  of the refined state, whichever is larger; inf where the program reports
  a window as not converged that the reference converges;
- ``ba_motion_px``: the refined motions against the optimum's;
- ``ba_cov_rel``: the refined motions' covariances against the
  reference's at the program's solution (relative Frobenius gap);
- ``chain_m``: both trajectories against the reference's composition of
  the program's window outputs.

On earlier lines a run prints sanity figures against the renderer's truth:
the track tables' median distance from where the birth point appears, the
window motions' median gap from the true motions, and both ATEs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ba as rba
from ..reference import geometry as g
from ..reference import photometric as ph
from ..reference import unified as ru
from ..reference import vo as rvo
from ..reference.prec import F64, TF32, Prec
from ..spans import Capture, patch
from . import common


class Engine:
    def __init__(self, config: dict, traffic: dict, seed: int, device, small: dict):
        from uasl_motion_estimation_tpu_torch.models import pipeline as pl
        from uasl_motion_estimation_tpu_torch.models import smoother as sm
        from uasl_motion_estimation_tpu_torch.ops import image as im

        self.sm = sm
        traffic = {**traffic, **small.get("traffic", {})}
        k = traffic["flights"]
        s_world, s_ransac, s_pick, *s_more = common.seeds(seed, 2 + k)
        self.rig = common.rig_of(config, small)
        n = traffic["frames"]
        width = common.scene_of(config, small)["hall_half_width"]
        self.worlds = [common.World(s, self.rig, n, device, width) for s in [s_world, *s_more][:k]]
        self.judged = s_pick % k  # the flight the comparison judges
        self.world = self.worlds[self.judged]
        self.truth = rvo.truth_motions(self.world.poses)
        pipe = common.pipeline_config(config, self.rig, small)
        self.cfg = sm.SmootherConfig(pipe=pipe, **config["smoother"])
        self.sampler = pl.make_sampler(s_ransac, pipe.vo.n_ransac)
        self.wchunk = traffic["wchunk"]
        self.n_frames = n
        self.starts = sm.unified_window_starts(n, self.cfg.window, self.cfg.ba_rate)
        self.work_per_pass = k * (n - 1)
        self.windows_per_pass = k * len(self.starts)
        self.capture = cap = Capture(seed)
        self._undo = [
            patch(sm, "_build_window_tracks", cap.wrap("tracks")),
            patch(sm, "_group_vo", cap.wrap(
                "vo", lambda r: (r[0].motion, r[0].success, r[0].inlier_mask, r[1]))),
            patch(sm, "_group_ba", cap.wrap(
                "ba", lambda r: (r[0].cam, r[0].pts, r[0].mask, r[1].cam, r[1].pts,
                                 r[1].cost, r[1].converged), lambda r: (r[1].converged,))),
            patch(sm, "_group_covariances", cap.wrap("cov", lambda r: (r[1], r[2]))),
        ]
        self.SPANS = [(sm, "_build_window_tracks", "tracks"), (sm, "_group_vo", "solve"),
                      (sm, "_group_ba", "ba")]
        self.K1 = (im, "gather_tiles")

    def run_pass(self) -> None:
        cur = self.capture.full if self.capture.on else None
        for world in self.worlds:
            out = self.sm.unified_system_scan(world.ls, world.rs, self.sampler, self.cfg,
                                              wchunk=self.wchunk)
            res = self.sm.compose_unified(out, self.n_frames, self.cfg)
            if cur is not None:  # what the wrappers captured belongs to this flight
                flight = {key: cur.pop(key) for key in ("tracks", "vo", "ba", "cov")}
                flight["out"] = (out, res)
                cur.setdefault("flights", []).append(flight)

    def failed(self) -> int:
        """Windows whose BA did not converge over the window's passes."""
        return sum(int((~c).sum()) for c in self.capture.tallied("ba"))

    def lm_iters(self) -> list:
        return []

    def release(self) -> None:
        for u in self._undo:
            u()

    # -- the comparison ---------------------------------------------------

    def _outputs(self, cap: dict) -> dict:
        cap = cap["flights"][self.judged]
        cat = lambda key, k: torch.cat([x[k] for x in cap[key]])  # noqa: E731
        obs = torch.cat([x[0] for x in cap["tracks"]])
        mask = torch.cat([x[1] for x in cap["tracks"]])
        out, res = cap["out"]
        return dict(obs=obs, mask=mask, vo_motion=cat("vo", 0), vo_success=cat("vo", 1),
                    inliers=cat("vo", 2), motions_local=cat("vo", 3),
                    start_cam=cat("ba", 0), start_pts=cat("ba", 1), start_mask=cat("ba", 2),
                    cam=cat("ba", 3), pts=cat("ba", 4), cost=cat("ba", 5), converged=cat("ba", 6),
                    motion_cov=cat("cov", 0), refined=cat("cov", 1),
                    vo_n_inliers=out.vo_n_inliers, frame_obs=out.n_frame_obs,
                    traj_vo=res.traj_vo, traj_ba=res.traj_ba)

    def _window_quads(self, obs, mask):
        """Each window's step quad matches (K(W-1), M, 4, 2), their validity,
        and the frames of each step."""
        K, W, M = mask.shape
        quads = torch.stack([obs[:, :-1, :, 0:2], obs[:, :-1, :, 2:4],
                             obs[:, 1:, :, 0:2], obs[:, 1:, :, 2:4]], -2)
        steps = torch.as_tensor(self.starts)[:, None] + torch.arange(W - 1)[None, :]
        return quads.reshape(-1, M, 4, 2), mask[:, 1:].reshape(-1, M), steps.reshape(-1)

    def _tracks_truth_px(self, obs, mask) -> float:
        """Median distance of the valid observations from where each track's
        birth point appears (a sanity figure)."""
        K, W, M = mask.shape
        T = torch.as_tensor(self.world.poses, dtype=torch.float64, device=obs.device)
        s = torch.as_tensor(self.starts, device=obs.device)
        X = g.cast(self.world.planes, T[s], obs[:, 0, :, 0:2], self.rig, F64)
        errs = []
        for j in range(W):
            Tj = T[s + j]
            left = torch.linalg.norm(obs[:, j, :, 0:2].double() - g.project(Tj, X, self.rig, F64),
                                     dim=-1)
            right = torch.linalg.norm(obs[:, j, :, 2:4].double()
                                      - g.project(Tj, X, self.rig, F64, right=True), dim=-1)
            errs.append((right if j == 0 else torch.maximum(left, right))[mask[:, j]])
        return common.median_of(torch.cat(errs))

    def _tracks_steps(self, obs, mask) -> torch.Tensor:
        """Per valid observation, the larger of the reference's KLT step from
        the track's previous frame and its stereo step."""
        K, W, M = mask.shape
        ls, rs = self.world.ls, self.world.rs
        s = torch.as_tensor(self.starts, device=obs.device)
        o = obs.double()
        out = []
        for j in range(W):
            f = s + j
            step = ph.stereo_step(ls[f], rs[f], o[:, j, :, 0:2], o[:, j, :, 2:4])
            if j > 0:
                step = torch.maximum(step, ph.klt_step(ls[f - 1], ls[f], o[:, j - 1, :, 0:2],
                                                       o[:, j, :, 0:2]))
            out.append(step[mask[:, j]])
        return torch.cat(out)

    def _numbers(self, o: dict) -> tuple[dict, dict]:
        """(the compared numbers, the sanity figures) of a subject's pass."""
        rig, cfg = self.rig, self.cfg
        out = {"tracks_px": common.median_of(self._tracks_steps(o["obs"], o["mask"]))}
        quads, valid, steps = self._window_quads(o["obs"], o["mask"])
        K, W = o["mask"].shape[:2]
        out.update(common.judge_steps(quads, valid, o["inliers"].reshape(K * (W - 1), -1),
                                      o["vo_motion"].reshape(-1, 4, 4),
                                      o["vo_success"].reshape(-1), self.truth[steps], rig))
        # the BA start, from the subject's own motions and tracks
        R0, t0, X0, gated, worst = ru.window_start(o["motions_local"], o["obs"], o["mask"], rig,
                                                   cfg.ba_min_obs, cfg.track_gate_px, F64)
        cam = o["start_cam"].double()
        Rs = g.rodrigues(cam[..., :3])
        cgap = g.pose_gap_px(g.rigid(Rs, cam[..., 3:]), g.rigid(R0, t0), rig.fu).amax(-1)
        pgap = rig.fu * torch.linalg.norm(o["start_pts"].double() - X0, dim=-1) / X0[..., 2].abs()
        pgap = torch.where(gated.any(1), pgap, torch.zeros_like(pgap)).amax(-1)
        differ = (gated != o["start_mask"]).any(1) & ((worst - cfg.track_gate_px).abs() > 1e-3)
        start = torch.maximum(cgap, pgap)
        start = torch.where(differ.any(-1), torch.full_like(start, torch.inf), start)
        out["ba_start_px"] = float(start.max())
        # BA: the reference optimum of the subject's start
        mask = o["start_mask"]
        R, t, X, c, conv = rba.solve(Rs, cam[..., 3:], o["start_pts"], o["obs"], mask, rig,
                                     cfg.n_fixed, cfg.huber_delta, F64)
        sc = o["cam"].double()
        Rp = g.rodrigues(sc[..., :3])
        cp = rba.cost(Rp, sc[..., 3:], o["pts"].double(), o["obs"].double(), mask.double(), rig,
                      cfg.huber_delta, F64)
        rel = torch.maximum(cp / c - 1.0, (o["cost"].double() - cp).abs() / c)
        unconverged = conv & ~o["converged"].to(conv.device)
        rel = torch.where(unconverged, torch.full_like(rel, torch.inf), rel)
        out["ba_cost_rel"] = float(rel.max())
        Tr = g.rigid(R, t)
        ref_motion = Tr[:, 1:] @ torch.linalg.inv(Tr[:, :-1])
        out["ba_motion_px"] = float(g.pose_gap_px(o["refined"], ref_motion, rig.fu).max())
        cc = rba.camera_covariances(Rp, sc[..., 3:], o["pts"], o["obs"], mask, rig, cfg.n_fixed,
                                    cfg.huber_delta, F64)
        mc = rba.motion_covariances(Rp, sc[..., 3:], cc, F64)
        num = torch.linalg.norm((o["motion_cov"].double() - mc).flatten(-2), dim=-1)
        out["ba_cov_rel"] = float((num / torch.linalg.norm(mc.flatten(-2), dim=-1)
                                   .clamp(min=1e-30)).max())
        ref_vo, ref_ba = ru.compose(o["motions_local"].cpu().numpy(), o["vo_success"].cpu().numpy(),
                                    np.asarray(o["vo_n_inliers"]), o["refined"].cpu().numpy(),
                                    np.asarray(o["frame_obs"]), self.starts, self.n_frames,
                                    rig.fu, cfg.min_frame_obs, cfg.install_disc_px, F64)
        out["chain_m"] = float(max(
            np.linalg.norm(np.asarray(o["traj_vo"])[:, :3, 3] - ref_vo[:, :3, 3], axis=-1).max(),
            np.linalg.norm(np.asarray(o["traj_ba"])[:, :3, 3] - ref_ba[:, :3, 3], axis=-1).max()))
        extras = {"tracks_truth_px": self._tracks_truth_px(o["obs"], o["mask"]),
                  "vo_truth_px": out.pop("vo_truth_px")}
        return out, extras

    def judge(self, cap: dict) -> dict:
        out, self._extras = self._numbers(self._outputs(cap))
        return out

    def control(self, cap: dict) -> dict:
        """The numbers of the reference put in the program's place in TF32:
        its track tables of the program's birth points, its window motions,
        BA start, BA, covariances and composition."""
        o = self._outputs(cap)
        p: Prec = TF32
        rig, cfg = self.rig, self.cfg
        K, W, M = o["mask"].shape
        dev = o["obs"].device
        T = torch.as_tensor(self.world.poses, dtype=torch.float64, device=dev)
        s = torch.as_tensor(self.starts, device=dev)
        X = g.cast(self.world.planes, T[s], o["obs"][:, 0, :, 0:2], rig, p)
        obs = torch.stack([torch.cat([g.project(T[s + j], X, rig, p),
                                      g.project(T[s + j], X, rig, p, right=True)], -1)
                           for j in range(W)], 1)
        mask = o["mask"] & torch.isfinite(obs).all(-1)
        obs = torch.nan_to_num(obs)
        quads, valid, steps = self._window_quads(obs, mask)
        use = o["inliers"].reshape(K * (W - 1), -1) & valid
        motion, cost = rvo.solve_motion(quads, use, rig, p, init=self.truth[steps].to(dev))
        success = (use.sum(-1) >= 6) & torch.isfinite(cost)
        eye = torch.eye(4, dtype=p.dtype, device=dev)
        local = torch.where(success[:, None, None], motion, eye).reshape(K, W - 1, 4, 4)
        R0, t0, X0, gated, _ = ru.window_start(local, obs, mask, rig, cfg.ba_min_obs,
                                               cfg.track_gate_px, p)
        R, t, Xs, c, conv = rba.solve(R0, t0, X0, obs, gated, rig, cfg.n_fixed, cfg.huber_delta, p)
        Tr = g.rigid(R, t)
        refined = p.mm(Tr[:, 1:], torch.linalg.inv(Tr[:, :-1]))
        cc = rba.camera_covariances(R, t, Xs, obs, gated, rig, cfg.n_fixed, cfg.huber_delta, p)
        mcov = rba.motion_covariances(R, t, cc, p)
        frame_obs = gated.sum(-1).cpu().numpy()
        traj_vo, traj_ba = ru.compose(local.cpu().numpy(), success.reshape(K, W - 1).cpu().numpy(),
                                      use.sum(-1).reshape(K, W - 1).cpu().numpy(),
                                      refined.cpu().numpy(), frame_obs, self.starts, self.n_frames,
                                      rig.fu, cfg.min_frame_obs, cfg.install_disc_px, p)
        cam6 = torch.cat([g.so3_log(R0), t0], -1)
        return self._numbers(dict(
            obs=obs, mask=mask, vo_motion=motion.reshape(K, W - 1, 4, 4),
            vo_success=success.reshape(K, W - 1), inliers=use.reshape(K, W - 1, -1),
            motions_local=local, start_cam=cam6, start_pts=X0, start_mask=gated,
            cam=torch.cat([g.so3_log(R), t], -1), pts=Xs, cost=c, converged=conv,
            motion_cov=mcov, refined=refined, vo_n_inliers=use.sum(-1).reshape(K, W - 1).cpu().numpy(),
            frame_obs=frame_obs, traj_vo=traj_vo, traj_ba=traj_ba))[0]

    def sanity(self, cap: dict) -> list[str]:
        """Figures against the renderer's truth, after ``judge``."""
        o = self._outputs(cap)
        gt = self.world.poses[:, :3, 3]
        return [f"sanity: ATE VO {rvo.ate_rmse(o['traj_vo'][:, :3, 3], gt):.5f} m, after BA "
                f"{rvo.ate_rmse(o['traj_ba'][:, :3, 3], gt):.5f} m against the renderer's poses; "
                f"{int(o['converged'].sum())}/{o['converged'].numel()} windows converged; "
                f"{int(o['vo_success'].sum())}/{o['vo_success'].numel()} window motions solved; "
                f"tracks {self._extras['tracks_truth_px']:.4f} px and window motions "
                f"{self._extras['vo_truth_px']:.4f} px (medians) from the truth"]
