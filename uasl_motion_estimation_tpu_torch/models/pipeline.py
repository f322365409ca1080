"""End-to-end stereo odometry pipeline: frames in, trajectory out.

Port of ``uasl_motion_estimation_tpu/models/pipeline.py``: front-end
(models/frontend.py) -> stereo VO (models/stereo_vo.py) -> pose chain
composed on the host in float64.

The staged engine keeps the JAX design: frames go to the device once as
uint8; each group of ``chunk`` steps converts its ``chunk + 1`` frames to
f32 and builds their left pyramids ONCE, then runs all its steps as one
batch (the leading dim that ``vmap`` gives in JAX). The streaming engine
runs the same scan on chunks uploaded by a background thread
(``stream_stacks``) while the previous chunk computes. RANSAC samples for
step ``i`` come from a generator keyed on the global step index, so the
per-frame, staged and streaming engines solve step ``i`` with the same
samples.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ..device import setup_device
from ..ops import geometry as geo
from ..ops import image as im
from ..utils import profiling
from . import frontend as fe
from .stereo_vo import StereoVOParams, _sample_hypotheses, sample_generator, stereo_vo_solve

# sampler(step, valid (N,) bool) -> (n_ransac, k) int64 match-index samples
Sampler = Callable[[int, torch.Tensor], torch.Tensor]


def make_sampler(seed: int, n_ransac: int, k: int = 3, stream: int = 0) -> Sampler:
    """Gumbel-top-k samples from a generator keyed on (seed, global step,
    ``stream``): every engine solves step i with the same samples; a
    non-zero ``stream`` draws another set for the same step (the mono
    hybrid's 5-point escalation takes stream 5, where JAX folds 5 into the
    step's key)."""

    def sample(step: int, valid: torch.Tensor) -> torch.Tensor:
        return _sample_hypotheses(sample_generator(seed, step, valid.device, stream), n_ransac,
                                  valid, k=k)

    return sample


def stream_stacks(stacks: Iterable[tuple[list, Any]], device: torch.device,
                  prefetch: int = 2, stats: dict | None = None
                  ) -> Iterator[tuple[torch.Tensor, torch.Tensor, Any]]:
    """Upload host frame stacks in a background thread while the caller
    computes on the previous one.

    ``stacks`` yields (frames, meta): a list of (left, right) uint8 (H, W)
    arrays and anything the caller wants back with it; it is consumed in the
    uploader thread. Each stack is packed into a pinned host tensor and
    copied on a copy stream with ``non_blocking=True``; the caller's stream
    waits on the copy's event before it reads. The uploader takes a stack
    from ``stacks`` only while fewer than ``prefetch`` uploaded stacks wait
    for the caller, so the device holds at most ``prefetch + 1`` stacks
    (the bound the reference's streaming engines state), provided the
    caller drops each stack before it asks for the next. Yields (lefts,
    rights, meta) with lefts and rights (n, H, W) uint8 on ``device``.
    ``stats``, when given, gets per stack
    ``upload_s`` (from packing to the copy's completion, timed in the
    uploader thread, so it overlaps compute) and ``upload_bytes``."""
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue()
    ahead = threading.Semaphore(prefetch)  # uploaded stacks the caller has not taken
    stop = threading.Event()
    if stats is not None:
        stats.setdefault("upload_s", [])
        stats.setdefault("upload_bytes", [])

    def upload(stack):
        t0 = time.perf_counter()
        h, w = stack[0][0].shape
        host = torch.empty((2, len(stack), h, w), dtype=torch.uint8, pin_memory=cuda)
        arr = host.numpy()
        for i, (left, right) in enumerate(stack):
            arr[0, i] = left
            arr[1, i] = right
        done = None
        if cuda:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                staged = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
        else:
            staged = host
        if stats is not None:
            if done is not None:
                done.synchronize()
            stats["upload_s"].append(time.perf_counter() - t0)
            stats["upload_bytes"].append(staged.numel())
        return staged, done

    def reserve() -> bool:
        while not stop.is_set():
            if ahead.acquire(timeout=0.1):
                return True
        return False

    def uploader():
        try:
            it = iter(stacks)
            while reserve():
                item = next(it, None)
                if item is None:
                    break
                q.put((*upload(item[0]), item[1]))
        except Exception as e:  # handed to the consumer, which raises it
            q.put(e)
            return
        q.put(None)

    thread = threading.Thread(target=uploader, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            ahead.release()
            staged, done, meta = item
            del item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                staged.record_stream(stream)
            yield staged[0], staged[1], meta
            del staged  # the caller is done with it
    finally:
        stop.set()
        thread.join()


def _u8(frame) -> np.ndarray:
    return np.clip(np.asarray(frame), 0, 255).astype(np.uint8)


class PipelineConfig(NamedTuple):
    vo: StereoVOParams
    max_features: int = 500  # TrackingInfo.nb_feats default (file_IO.h:69-73)
    matcher: fe.MatcherConfig = fe.MatcherConfig()
    klt: fe.KLTConfig = fe.KLTConfig()
    detect_nms_radius: int = 5
    detect_quality: float = 1e-4
    detector: str = "grid"  # "grid" bucketed GFTT or "topk" global top-k with NMS


class FrameOutput(NamedTuple):
    motion: torch.Tensor  # (..., 4, 4) prev-cam -> cur-cam
    state: torch.Tensor  # (..., 6)
    success: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    mean_reproj_error: torch.Tensor
    cov: torch.Tensor  # (..., 6, 6) motion covariance ([dt, dtheta] tangent)


def _step(prev_left, prev_right, cur_left, cur_right, steps, sampler, cfg,
          pyr_prev=None, pyr_cur=None) -> FrameOutput:
    """Front-end + pose solve for a batch of steps (global indices
    ``steps``) on f32 images (B, H, W)."""
    with profiling.span("vo.frontend"):
        qm = fe.quad_match_frames(
            prev_left, prev_right, cur_left, cur_right,
            max_features=cfg.max_features, matcher=cfg.matcher, klt=cfg.klt,
            detect_kwargs=(("nms_radius", cfg.detect_nms_radius),
                           ("quality_level", cfg.detect_quality)),
            detector=cfg.detector, pyr_prev_left=pyr_prev, pyr_cur_left=pyr_cur,
        )
    samples = None
    if cfg.vo.ransac:
        with profiling.span("vo.sample"):
            samples = torch.stack([sampler(s, v) for s, v in zip(steps, qm.valid, strict=True)])
    with profiling.span("vo.solve"):
        res = stereo_vo_solve(qm.uv, qm.valid, None, cfg.vo, samples=samples)
    return FrameOutput(motion=res.motion, state=res.state, success=res.success,
                       n_matches=torch.sum(qm.valid, dim=-1), n_inliers=res.n_inliers,
                       mean_reproj_error=res.mean_reproj_error, cov=res.cov)


def vo_step(prev_left, prev_right, cur_left, cur_right, step: int,
            sampler: Sampler, cfg: PipelineConfig) -> FrameOutput:
    """One frame of odometry on (H, W) images (uint8 or f32; compute is f32)."""
    imgs = [x.to(torch.float32)[None] for x in (prev_left, prev_right, cur_left, cur_right)]
    out = _step(*imgs, [step], sampler, cfg)
    return FrameOutput(*(x[0] for x in out))


def vo_sequence_scan_shared(ls: torch.Tensor, rs: torch.Tensor, step0: int,
                            sampler: Sampler, cfg: PipelineConfig,
                            chunk: int = 8) -> FrameOutput:
    """All n-1 steps of a staged sequence (n, H, W), ``chunk`` steps at a
    time. Per group, the f32 conversion and KLT pyramids of its chunk+1
    frames are built once and shared by the two steps that use each frame;
    device memory for front-end intermediates stays O(chunk) frames. The
    last group may be shorter (no padded steps are computed).

    Returns FrameOutput with n-1 entries along the leading dim."""
    n = int(ls.shape[0])
    outs = []
    for base in range(0, n - 1, chunk):
        with profiling.span("vo.chunk"):
            m = min(chunk, n - 1 - base)
            lf = ls[base:base + m + 1].to(torch.float32)
            rf = rs[base:base + m + 1].to(torch.float32)
            pyr = im.build_pyramid(lf, cfg.klt.n_levels)
            outs.append(_step(
                lf[:-1], rf[:-1], lf[1:], rf[1:],
                list(range(step0 + base, step0 + base + m)), sampler, cfg,
                pyr_prev=[p[:-1] for p in pyr], pyr_cur=[p[1:] for p in pyr]))
    return FrameOutput(*(torch.cat(xs) for xs in zip(*outs)))


def _vo_scan_packed(ls, rs, step0, sampler, cfg, chunk) -> torch.Tensor:
    """vo_sequence_scan_shared with the per-step outputs packed into one
    (B, 20) f32 tensor [motion 16, success, n_matches, n_inliers,
    mean_reproj_error], so the host reads them in one transfer."""
    out = vo_sequence_scan_shared(ls, rs, step0, sampler, cfg, chunk)
    b = out.motion.shape[0]
    f32 = out.motion.dtype
    return torch.cat([
        out.motion.reshape(b, 16),
        out.success[:, None].to(f32),
        out.n_matches[:, None].to(f32),
        out.n_inliers[:, None].to(f32),
        out.mean_reproj_error[:, None].to(f32),
    ], dim=1)


class OdometryPipeline:
    """Host-side frame loop with the reference's degraded-frame contract: a
    failed frame keeps the last pose (SURVEY.md section 5).

    ``sampler``: optional replacement for the RANSAC sampler, called as
    ``sampler(step, valid)`` (a test seam for injecting reference samples).
    """

    def __init__(self, cfg: PipelineConfig, seed: int = 0, logger=None,
                 device: str | torch.device | None = None,
                 sampler: Sampler | None = None):
        self.cfg = cfg
        self.seed = seed
        self.logger = logger
        self.device = setup_device(device)
        self._sample = make_sampler(seed, cfg.vo.n_ransac)
        self.sampler = sampler or self._sample
        self.reset()

    def reset(self):
        self.pose = np.eye(4)  # cam-to-world of current frame
        self.trajectory = [self.pose.copy()]
        self.prev_pair: tuple | None = None
        self.frame_idx = 0

    def _to_device(self, img, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img)).to(device=self.device, dtype=dtype)

    def _chain(self, packed: np.ndarray) -> None:
        """Compose the host pose chain in float64 from packed step rows."""
        with profiling.span("vo.chain"):
            pose = self.pose.copy()
            for i in range(packed.shape[0]):
                success = bool(packed[i, 16] > 0.5)
                if success:
                    # pose_cur = pose_prev * motion^-1 (motion maps prev->cur pts)
                    pose = pose @ np.linalg.inv(packed[i, :16].reshape(4, 4).astype(np.float64))
                self.trajectory.append(pose.copy())
                if self.logger is not None:
                    self.logger.log(frame=self.frame_idx + i + 1, success=success,
                                    n_matches=int(packed[i, 17]), n_inliers=int(packed[i, 18]),
                                    mean_reproj_error=float(packed[i, 19]))
            self.pose = pose

    def process_pair(self, left: np.ndarray, right: np.ndarray) -> dict:
        """Feed one stereo pair; returns the per-frame metrics record."""
        left = self._to_device(left, torch.float32)
        right = self._to_device(right, torch.float32)
        rec: dict = {"frame": self.frame_idx}
        if self.prev_pair is not None:
            out = vo_step(*self.prev_pair, left, right, self.frame_idx - 1,
                          self.sampler, self.cfg)
            motion, success, n_m, n_i, err = (
                t.cpu().numpy() for t in (out.motion, out.success, out.n_matches,
                                          out.n_inliers, out.mean_reproj_error))
            if bool(success):
                self.pose = self.pose @ np.linalg.inv(motion.astype(np.float64))
            rec.update(success=bool(success), n_matches=int(n_m), n_inliers=int(n_i),
                       mean_reproj_error=float(err))
            self.trajectory.append(self.pose.copy())
        self.prev_pair = (left, right)
        self.frame_idx += 1
        if self.logger is not None:
            self.logger.log(**rec)
        return rec

    def run(self, frames: Iterable[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
        """Process a whole sequence pair by pair; (N, 4, 4) cam-to-world poses."""
        for left, right in frames:
            self.process_pair(left, right)
        return np.asarray(self.trajectory)

    def stage_frames(self, frames: list[tuple[np.ndarray, np.ndarray]]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Upload a frame sequence to the device as uint8 (4x fewer bytes
        than f32; converted on the device). Returns (lefts, rights)."""
        ls = np.stack([np.asarray(f[0]) for f in frames])
        rs = np.stack([np.asarray(f[1]) for f in frames])
        ls = self._to_device(np.clip(ls, 0, 255).astype(np.uint8), torch.uint8)
        rs = self._to_device(np.clip(rs, 0, 255).astype(np.uint8), torch.uint8)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return ls, rs

    def run_staged(self, ls: torch.Tensor, rs: torch.Tensor, chunk: int = 8) -> np.ndarray:
        """Whole staged sequence; the per-step outputs come back in one
        transfer and the pose chain is composed on the host in float64.
        Returns (N, 4, 4) cam-to-world poses."""
        n = int(ls.shape[0])
        packed = _vo_scan_packed(ls, rs, self.frame_idx, self.sampler, self.cfg,
                                 chunk).cpu().numpy()
        profiling.count("sync.vo_readback")
        self._chain(packed)
        self.frame_idx += n
        return np.asarray(self.trajectory)

    def run_streaming(self, frames: Iterable[tuple[np.ndarray, np.ndarray]], chunk: int = 16,
                      prefetch: int = 2, stats: dict | None = None) -> np.ndarray:
        """Streaming mode: upload/compute overlap and bounded device memory.

        ``frames`` is any iterable of (left, right) pairs. A background
        thread packs (chunk + 1)-frame uint8 stacks, the last frame of one
        chunk leading the next, and uploads them (``stream_stacks``); each
        chunk's steps run as one ``run_staged`` group as soon as its stack
        is on the device. The tail stack is padded to the same shape by
        repeating its last frame, and its padded steps are dropped before
        the scan (they could only give identity motions). Samples are keyed
        on global step indices, so the trajectory is ``run_staged``'s.
        ``stats``, when given, gets the in-run ``upload_s`` and
        ``upload_bytes`` per chunk. Returns (N, 4, 4) cam-to-world poses."""

        def stacks():
            boundary = None  # last frame of the previous chunk
            buf: list = []
            want = chunk + 1
            for f in frames:
                buf.append((_u8(f[0]), _u8(f[1])))
                if len(buf) == want:
                    stack = ([boundary] if boundary is not None else []) + buf
                    yield stack, chunk
                    boundary, buf, want = stack[-1], [], chunk
            if buf and (boundary is not None or len(buf) > 1):
                stack = ([boundary] if boundary is not None else []) + buf
                yield stack + [stack[-1]] * (chunk + 1 - len(stack)), len(stack) - 1

        packed, n_frames, step = [], 0, self.frame_idx
        for ls, rs, real in stream_stacks(stacks(), self.device, prefetch, stats):
            packed.append(_vo_scan_packed(ls[:real + 1], rs[:real + 1], step, self.sampler,
                                          self.cfg, chunk))
            n_frames = (n_frames or 1) + real
            step += real
            del ls, rs  # before the next stack is taken (stream_stacks' bound)
        if packed:
            self._chain(torch.cat(packed).cpu().numpy())
        self.frame_idx += n_frames
        return np.asarray(self.trajectory)

    def run_sequence(self, frames: list[tuple[np.ndarray, np.ndarray]], chunk: int = 8
                     ) -> np.ndarray:
        """Alias: ``stage_frames`` then ``run_staged``."""
        ls, rs = self.stage_frames(frames)
        return self.run_staged(ls, rs, chunk=chunk)

    def run_batched(self, frames: list[tuple[np.ndarray, np.ndarray]], chunk: int = 16
                    ) -> np.ndarray:
        """Alias for ``run_streaming``."""
        return self.run_streaming(frames, chunk=chunk)


def default_config(
    intr: geo.Intrinsics,
    baseline: float,
    image_shape: tuple[int, int] | None = None,
    **vo_overrides,
) -> PipelineConfig:
    """Reference-default pipeline config; ``image_shape`` (h, w) scales the
    RANSAC spread gate (1000 px^2 at KITTI resolution, cpp:63) with area."""
    if image_shape is not None and "min_spread_area" not in vo_overrides:
        h, w = image_shape
        vo_overrides["min_spread_area"] = 1000.0 * (h * w) / (376.0 * 1241.0)
    vo = StereoVOParams(intr1=intr, intr2=intr, baseline=baseline, **vo_overrides)
    return PipelineConfig(vo=vo)
