"""Batched windowed BA: a whole drive's windows in one ``ba_solve`` a pass.

Traffic parameters: ``windows``, ``frames`` (cameras a window),
``points``, ``noise_px``, ``trace_passes``. Window w is the JAX package's
BA test window (``world.render_torch.ba_window``) drawn with seed w at the
configuration's intrinsics, baseline and image, and started from its
perturbation with seed w + 100 (``perturb_ba_window``), as the published
config 4 draws its 16 (``ba_windows`` builds them all at once); the run's
seed sets the order of the windows in the batch. Every seed so solves the
same set (a batch iterates until its slowest window is done, so windows
drawn anew each seed would change the work). The batch is uploaded in set-up. The comparison judges one pass
against the reference's float64 optimum of the same windows from the same
start:

- ``ba_cost_rel``: each window's refined cost over the optimum, less one,
  or the reported cost's gap from the cost of the refined state, whichever
  is larger (relative to the optimum); inf where the program reports a
  window as not converged that the reference converges;
- ``ba_cam_px``: the largest camera gap from the optimum (pixels at 15 m).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ba as rba
from ..reference import geometry as g
from ..reference.prec import F64, TF32, Prec
from ..spans import Capture, patch
from ..world.render_torch import ba_windows
from . import common


class Engine:
    def __init__(self, config: dict, traffic: dict, seed: int, device, small: dict):
        from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
        from uasl_motion_estimation_tpu_torch.solvers import ba

        self.ba = ba
        traffic = {**traffic, **small.get("traffic", {})}
        self.rig = rig = common.rig_of(config, small)
        n = traffic["windows"]
        order = np.random.default_rng(common.seeds(seed, 1)[0]).permutation(n)
        intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
        windows = ba_windows(intr, rig.baseline, order.tolist(), traffic["frames"], traffic["points"],
                             traffic["noise_px"], (rig.height, rig.width))
        arrays = [torch.from_numpy(x).to(device) for x in windows]
        self.problem = ba.BAProblem(*arrays)
        self.start = [a.cpu() if device == "cpu" else a for a in arrays]
        bc = config["ba"]
        self.cfg = ba.BAConfig(intr=intr, baseline=rig.baseline, n_fixed=bc["n_fixed"],
                               max_iter=bc["max_iter"], huber_delta=bc["huber_delta"])
        self.device = device
        self.work_per_pass = n
        self.capture = Capture(seed)
        self._undo = [patch(ba, "ba_solve", self.capture.wrap(
            "res", lambda r: (r.cam, r.pts, r.cost, r.converged, r.n_iter),
            lambda r: (r.converged, r.n_iter)))]
        self.SPANS = []
        self.K1 = None

    def run_pass(self) -> None:
        self.ba.ba_solve(self.problem, self.cfg)
        if self.device != "cpu":
            torch.cuda.synchronize()

    def failed(self) -> int:
        """Windows that did not converge over the window's passes."""
        return sum(int((~c).sum()) for c in self.capture.tallied("res"))

    def lm_iters(self) -> list:
        """The largest LM iteration count of each solve of every pass."""
        return [int(n.max()) for n in self.capture.tallied("res", 1)]

    def release(self) -> None:
        for u in self._undo:
            u()
        del self.problem

    def _numbers(self, cam, pts, cost, converged) -> dict:
        c0, p0, obs, mask = self.start
        R0 = g.rodrigues(c0[..., :3].double())
        R, t, X, c, conv = rba.solve(R0, c0[..., 3:], p0, obs, mask, self.rig, self.cfg.n_fixed,
                                     self.cfg.huber_delta, F64)
        cam = cam.double()
        Rp = g.rodrigues(cam[..., :3])
        cp = rba.cost(Rp, cam[..., 3:], pts.double(), obs.double(), mask.double(), self.rig,
                      self.cfg.huber_delta, F64)
        den = c.clamp(min=1e-12)
        rel = torch.maximum((cp - c) / den, (cost.double() - cp).abs() / den)
        unconverged = conv & ~converged.to(conv.device)
        rel = torch.where(unconverged, torch.full_like(rel, torch.inf), rel)
        gap = g.pose_gap_px(g.rigid(Rp, cam[..., 3:]), g.rigid(R, t), self.rig.fu)
        return {"ba_cost_rel": float(rel.max()), "ba_cam_px": float(gap.max())}

    def judge(self, cap: dict) -> dict:
        cam, pts, cost, converged, _ = cap["res"][0]
        return self._numbers(cam, pts, cost, converged)

    def control(self, cap: dict) -> dict:
        """The numbers of the reference put in the program's place in TF32."""
        p: Prec = TF32
        c0, p0, obs, mask = self.start
        R, t, X, c, conv = rba.solve(g.rodrigues(c0[..., :3].double()).float(), c0[..., 3:], p0,
                                     obs, mask, self.rig, self.cfg.n_fixed, self.cfg.huber_delta, p)
        return self._numbers(torch.cat([g.so3_log(R), t], -1), X, c, conv)

    def sanity(self, cap: dict) -> list[str]:
        _, _, cost, converged, n_iter = cap["res"][0]
        return [f"sanity: mean BA cost {float(cost.double().mean()):.6f} over {cost.numel()} windows; "
                f"{int(converged.sum())} converged; LM iterations up to {int(n_iter.max())}"]
