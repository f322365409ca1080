"""Dataset/config I/O: YML config ingestion, image sequence readers, CSV
sensor/ground-truth files with header discovery.

The port's copy of ``uasl_motion_estimation_tpu/utils/io.py`` (numpy only;
cv2 is imported inside the readers that decode images).

Host-side re-design of the reference's file_IO layer
(reference: include/MotionEstimation/core/file_IO.h:42-463,
src/core/file_IO.cpp:22-398). Differences by design:

* the reference's six process-wide config globals (file_IO.cpp:22-27) become
  one immutable ``SessionConfig`` returned by ``load_yml``;
* the same OpenCV-YML schema is ingested (nodes ``dataset``/``frames``/
  ``tracking``/``calib`` + ``appendix``) including the legacy key fallbacks
  (f1 vs fu1, cu vs cu1, file_IO.cpp:53-75) and defaults (skip=1,
  feat_cov=1.0, file_IO.h:61-62, 88-89);
* CSV readers keep the '#'-prefixed header-discovery contract and the
  time-sync semantics: IMU samples are AVERAGED up to a stamp
  (ImuFile::getNextData, file_IO.cpp:252-270), GPS/pose advance to the first
  sample past the stamp (cpp:272-294).
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from .sensors import GpsData, ImuData, PoseData


# ---------------------------------------------------------------------------
# Typed config (replaces FrameInfo/TrackingInfo/DatasetInfo + param globals)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FrameConfig:
    """file_IO.h:42-64."""

    start: int = 0  # fframe
    stop: int = -1  # lframe (-1 = all)
    skip: int = 1
    init: int = 0


@dataclass(frozen=True)
class TrackingConfig:
    """file_IO.h:67-91."""

    nb_feats: int = 500
    window_size: int = 5
    ba_rate: int = 5
    parallax: float = 10.0
    feat_cov: float = 1.0


@dataclass(frozen=True)
class CalibConfig:
    fu1: float = 1.0
    fv1: float = 1.0
    fu2: float = 1.0
    fv2: float = 1.0
    cu1: float = 0.0
    cu2: float = 0.0
    cv1: float = 0.0
    cv2: float = 0.0
    baseline: float = 1.0
    ransac: bool = True
    weighting: bool = False
    inlier_threshold: float = 2.0
    method: str = "GN"
    nb_fixed_frames: int = 2


@dataclass(frozen=True)
class DatasetConfig:
    """file_IO.h:94-144."""

    dir: str = ""
    type: str = "stereo"  # 'mono' | 'stereo'
    gt_file: str = ""
    imu_file: str = ""
    gps_file: str = ""
    image_file: str = ""
    cam_id: int = 0
    scale: float = 1.0


@dataclass(frozen=True)
class SessionConfig:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    frames: FrameConfig = field(default_factory=FrameConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    calib: CalibConfig = field(default_factory=CalibConfig)
    appendix: str = ""


def _yml_get(node, key, default=None):
    v = node.getNode(key) if node is not None else None
    if v is None or v.empty():
        return default
    if v.isInt():
        return int(v.real())
    if v.isReal():
        return v.real()
    if v.isString():
        return v.string()
    return default


def load_yml(path: str) -> SessionConfig:
    """Ingest a reference-format OpenCV YML config (loadYML,
    file_IO.cpp:30-98), returning an immutable typed config."""
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    if not fs.isOpened():
        raise FileNotFoundError(f"YML file could not be opened: {path}")
    try:
        ds = fs.getNode("dataset")
        fr = fs.getNode("frames")
        tk = fs.getNode("tracking")
        cb = fs.getNode("calib")

        dataset = DatasetConfig(
            dir=_yml_get(ds, "dir", "") or "",
            type=_yml_get(ds, "type", "stereo") or "stereo",
            gt_file=_yml_get(ds, "gt", "") or "",
            imu_file=_yml_get(ds, "imu", "") or "",
            gps_file=_yml_get(ds, "gps", "") or "",
            image_file=_yml_get(ds, "images", "") or "",
            cam_id=int(_yml_get(ds, "cam_ID", 0) or 0),
            scale=float(_yml_get(ds, "scale", 1.0) or 1.0),
        )
        frames = FrameConfig(
            start=int(_yml_get(fr, "start", 0) or 0),
            stop=int(_yml_get(fr, "stop", -1) if _yml_get(fr, "stop") is not None else -1),
            skip=int(_yml_get(fr, "skip", 1) or 1),  # default skip=1 (h:61-62)
            init=int(_yml_get(fr, "init", 0) or 0),
        )
        tracking = TrackingConfig(
            nb_feats=int(_yml_get(tk, "feats", 500) or 500),
            window_size=int(_yml_get(tk, "window", 5) or 5),
            ba_rate=int(_yml_get(tk, "ba_rate", 5) or 5),
            parallax=float(_yml_get(tk, "parallax", 10.0) or 10.0),
            feat_cov=float(_yml_get(tk, "feat_cov", 1.0) or 1.0),  # h:88-89
        )

        # legacy key fallbacks: f1/f2 preferred, else fu1/fu2 (cpp:39-47);
        # cu before cu1 etc. (cpp:53-75)
        fu1 = _yml_get(cb, "f1") or _yml_get(cb, "fu1", 1.0) or 1.0
        fu2 = _yml_get(cb, "f2") or _yml_get(cb, "fu2", fu1) or fu1
        fv1 = _yml_get(cb, "f1") or _yml_get(cb, "fv1", fu1) or fu1
        fv2 = _yml_get(cb, "f2") or _yml_get(cb, "fv2", fu2) or fu2
        # mono fallback: f / fu
        if not _yml_get(cb, "f1") and not _yml_get(cb, "fu1"):
            f = _yml_get(cb, "fu") or _yml_get(cb, "f", 1.0) or 1.0
            fu1 = fu2 = fv1 = fv2 = f
        cu = _yml_get(cb, "cu")
        cv_ = _yml_get(cb, "cv")
        calib = CalibConfig(
            fu1=float(fu1), fu2=float(fu2), fv1=float(fv1), fv2=float(fv2),
            cu1=float(cu if cu is not None else _yml_get(cb, "cu1", 0.0) or 0.0),
            cu2=float(cu if cu is not None else _yml_get(cb, "cu2", 0.0) or 0.0),
            cv1=float(cv_ if cv_ is not None else _yml_get(cb, "cv1", 0.0) or 0.0),
            cv2=float(cv_ if cv_ is not None else _yml_get(cb, "cv2", 0.0) or 0.0),
            baseline=float(_yml_get(cb, "baseline", 1.0) or 1.0),
            ransac=(_yml_get(cb, "ransac", "true") == "true"),
            weighting=(_yml_get(cb, "weighting", "false") == "true"),
            inlier_threshold=float(_yml_get(cb, "threshold", 2.0) or 2.0),
            method=_yml_get(cb, "method", "GN") or "GN",
            nb_fixed_frames=int(_yml_get(cb, "fixed_frames", 2) or 2),
        )
        appendix = _yml_get(fs.root(), "appendix", "") or ""
        return SessionConfig(dataset=dataset, frames=frames,
                             tracking=tracking, calib=calib, appendix=appendix)
    finally:
        fs.release()


# ---------------------------------------------------------------------------
# CSV files with '#' header discovery (IOFile, file_IO.h:224-297)
# ---------------------------------------------------------------------------


class CsvFile:
    """Reader for the reference's CSV format: a '#'-prefixed header names the
    columns; rows are comma-separated (check_header, file_IO.cpp:109-130)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path)
        header = self._fh.readline()
        pos = header.find("#")
        if pos < 0:
            self._fh.close()
            raise ValueError(f"could not find header in {path}")
        self.columns = [c.strip() for c in header[pos + 1 :].split(",")
                        if c.strip()]

    def rows(self) -> Iterator[dict]:
        for line in self._fh:
            vals = [v for v in re.split(r"[,\s]+", line.strip()) if v]
            if not vals:
                continue
            yield {c: float(v) for c, v in zip(self.columns, vals)}

    def close(self):
        self._fh.close()


class ImuFile(CsvFile):
    """IMU CSV with the reference's column names (acc_x.., av_x.., q_w..) and
    the average-up-to-stamp sync (getNextData, file_IO.cpp:252-270)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._iter = self.rows()
        self._pending: ImuData | None = None

    @staticmethod
    def _parse(row: dict) -> ImuData:
        q = np.array([row.get("q_w", 1.0), row.get("q_x", 0.0),
                      row.get("q_y", 0.0), row.get("q_z", 0.0)])
        return ImuData(
            acc=np.array([row.get("acc_x", 0.0), row.get("acc_y", 0.0),
                          row.get("acc_z", 0.0)]),
            gyr=np.array([row.get("av_x", 0.0), row.get("av_y", 0.0),
                          row.get("av_z", 0.0)]),
            pos=np.array([row.get("pos_x", 0.0), row.get("pos_y", 0.0),
                          row.get("pos_z", 0.0)]),
            orientation=q,
            stamp=int(row.get("timestamp", 0)),
        )

    def get_next(self, stamp: int) -> tuple[ImuData | None, int]:
        """Average all samples with stamp <= ``stamp``; returns
        (averaged sample or None, count)."""
        acc = ImuData()
        count = 0
        if self._pending is not None and self._pending.stamp <= stamp:
            acc += self._pending
            count += 1
            self._pending = None
        for row in self._iter:
            d = self._parse(row)
            if d.stamp > stamp:
                self._pending = d
                break
            acc += d
            count += 1
        if count == 0:
            return None, 0
        acc /= count
        return acc, count


class GpsFile(CsvFile):
    """GPS CSV; sync advances past the stamp (file_IO.cpp:272-283)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._iter = self.rows()

    def get_next(self, stamp: int) -> GpsData | None:
        for row in self._iter:
            d = GpsData(lon=row.get("lon", 0.0), lat=row.get("lat", 0.0),
                        alt=row.get("alt", 0.0),
                        stamp=int(row.get("timestamp", 0)))
            if d.stamp > stamp:
                return d
        return None


class PoseFile(CsvFile):
    """Pose CSV (x, y, z, q_w..q_z); sync like GPS (file_IO.cpp:285-294)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._iter = self.rows()

    def get_next(self, stamp: int) -> PoseData | None:
        for row in self._iter:
            d = PoseData(
                position=np.array([row.get("x", 0.0), row.get("y", 0.0),
                                   row.get("z", 0.0)]),
                orientation=np.array([row.get("q_w", 1.0), row.get("q_x", 0.0),
                                      row.get("q_y", 0.0), row.get("q_z", 0.0)]),
                stamp=int(row.get("timestamp", 0)),
            )
            if d.stamp > stamp:
                return d
        return None


# ---------------------------------------------------------------------------
# Image sequence readers (ImageReader, file_IO.h:300-421)
# ---------------------------------------------------------------------------


class ImageSequenceReader:
    """Stereo/mono frame reader over the reference's on-disk layouts:

    * generic: ``cam{N}_image{NNNNN}[_appendix].png`` (file_IO.cpp:296-310);
    * KITTI: ``L_{NNNNNN}.png`` / ``R_{NNNNNN}.png``, rows cropped to 374
      (file_IO.cpp:313-340);

    honoring FrameConfig start/stop/skip (ImageReader seek loop,
    file_IO.h:319-322).
    """

    def __init__(self, directory: str, frames: FrameConfig = FrameConfig(),
                 appendix: str = "", kitti_crop: int = 374):
        self.dir = directory
        self.frames = frames
        self.appendix = appendix
        self.kitti_crop = kitti_crop
        self.kitti = bool(glob.glob(os.path.join(directory, "L_*.png")))

    def _path(self, cam: int, idx: int) -> str:
        if self.kitti:
            prefix = "L" if cam == 0 else "R"
            return os.path.join(self.dir, f"{prefix}_{idx:06d}.png")
        suffix = f"_{self.appendix}" if self.appendix else ""
        return os.path.join(self.dir, f"cam{cam}_image{idx:05d}{suffix}.png")

    def read_frame(self, idx: int, stereo: bool = True):
        import cv2

        left = cv2.imread(self._path(0, idx), cv2.IMREAD_GRAYSCALE)
        if left is None:
            raise FileNotFoundError(self._path(0, idx))
        if self.kitti:
            left = left[: self.kitti_crop]
        if not stereo:
            return left.astype(np.float32)
        right = cv2.imread(self._path(1, idx), cv2.IMREAD_GRAYSCALE)
        if right is None:
            raise FileNotFoundError(self._path(1, idx))
        if self.kitti:
            right = right[: self.kitti_crop]
        return left.astype(np.float32), right.astype(np.float32)

    def __iter__(self):
        idx = self.frames.start
        while self.frames.stop < 0 or idx <= self.frames.stop:
            try:
                yield self.read_frame(idx)
            except FileNotFoundError:
                return
            idx += self.frames.skip


class ImageStampFile(CsvFile):
    """``image_data.csv`` (frame number, timestamp) reader — the reference's
    ``ImageFile`` (file_IO.h:252-263): each ``read_next`` advances one row and
    returns (img_nb, stamp) so frames can be time-synced with IMU/GPS."""

    def __init__(self, path: str):
        super().__init__(path)
        self._iter = self.rows()

    def read_next(self) -> tuple[int, int] | None:
        for row in self._iter:
            vals = list(row.values())
            if len(vals) < 2:
                continue
            return int(vals[0]), int(vals[1])
        return None


class EndOfStream(Exception):
    """A sequence reader ran out of frames/stamps (dedicated type so it can
    propagate through generator frames, unlike StopIteration under PEP 479)."""


class VideoSequenceReader:
    """Stereo/mono reader over per-camera video streams
    ``cam{N}_image.avi`` — the reference ImageReader's VIDEO mode
    (file_IO.h:300-421: opens one cv::VideoCapture per camera, grabs frames
    up to the current frame number honoring skip, converts BGR->gray).

    Optionally consumes an ``image_data.csv`` stamp file so ``read_frame``
    tracks timestamps exactly like the reference (readStereo,
    file_IO.h:351-387)."""

    def __init__(self, directory: str, frames: FrameConfig = FrameConfig(),
                 stereo: bool = True, stamp_file: str | None = None):
        import cv2

        self.dir = directory
        self.frames = frames
        self.stereo = stereo
        n_cams = 2 if stereo else 1
        self.caps = [
            cv2.VideoCapture(os.path.join(directory, f"cam{i}_image.avi"))
            for i in range(n_cams)
        ]
        self.img_nb = 0
        self.img_stamp = 0
        self._stamps: ImageStampFile | None = None
        if stamp_file:
            self._stamps = ImageStampFile(stamp_file)
        # seek to the first frame (ImageReader ctor loop, file_IO.h:319-322)
        while self.img_nb < frames.start:
            self._advance(1)

    def is_valid(self) -> bool:
        return self.img_nb > 0 or any(c.isOpened() for c in self.caps)

    def _advance(self, skip: int):
        if self._stamps is not None:
            for _ in range(skip):
                nxt = self._stamps.read_next()
                if nxt is None:
                    raise EndOfStream(f"stamp file exhausted in {self.dir}")
                self.img_nb, self.img_stamp = nxt
        else:
            self.img_nb += skip

    def read_frame(self):
        """Grab the next frame pair (or mono frame) honoring skip; returns
        float32 grayscale array(s). Raises EndOfStream at stream end
        (NOT StopIteration: that would silently vanish — or turn into a
        RuntimeError under PEP 479 — inside generator-based callers, and as
        a constructor error it is misleading)."""
        import cv2

        self._advance(self.frames.skip)
        out = []
        for cap in self.caps:
            if not cap.isOpened():
                raise EndOfStream(f"video stream not open in {self.dir}")
            while cap.get(cv2.CAP_PROP_POS_FRAMES) < self.img_nb:
                if not cap.grab():
                    raise EndOfStream(f"video stream exhausted in {self.dir}")
            ok, img = cap.read()
            if not ok:
                raise EndOfStream(f"video stream exhausted in {self.dir}")
            if img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            out.append(img.astype(np.float32))
        return tuple(out) if self.stereo else out[0]

    def __iter__(self):
        while self.frames.stop < 0 or self.img_nb < self.frames.stop:
            try:
                yield self.read_frame()
            except EndOfStream:
                return

    def close(self):
        for cap in self.caps:
            cap.release()


class GTReader:
    """Ground-truth pose reader (GTReader, file_IO.h:424-463).

    Line format mirrors readPoseLine (file_IO.h:437-461):
    ``timestamp, ox, oy, oz, ow, x, y, z`` — four orientation values in
    file order (x, y, z, w; the reference builds Quat{o[3], o[0], o[1],
    o[2]}), then position. The first line is a free-form header
    (readHeader, file_IO.h:432-436).

    Beyond per-line reads, provides the time-synced retrieval the round-1
    port lacked: ``get_next(stamp)`` advances to the first pose at/after a
    stamp (the getNextData convention of the sensor files,
    file_IO.cpp:285-294) and ``pose_at(stamp)`` interpolates the bracketing
    poses (lerp position, slerp orientation) for RPE evaluation against
    arbitrary frame stamps.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path)
        self.header = self._fh.readline().rstrip("\n")
        self._pending: tuple[int, np.ndarray, np.ndarray] | None = None

    def read_pose_line(self) -> tuple[int, np.ndarray, np.ndarray] | None:
        """(stamp, quat [w,x,y,z], position) of the next line, or None."""
        for line in self._fh:
            vals = [v for v in re.split(r"[,\s]+", line.strip()) if v]
            if len(vals) < 8:
                continue
            stamp = int(float(vals[0]))
            o = [float(v) for v in vals[1:5]]
            pos = np.array([float(v) for v in vals[5:8]])
            quat = np.array([o[3], o[0], o[1], o[2]])  # file order x,y,z,w
            return stamp, quat, pos
        return None

    def _next_entry(self):
        if self._pending is not None:
            e, self._pending = self._pending, None
            return e
        return self.read_pose_line()

    def get_next(self, stamp: int) -> PoseData | None:
        """First pose with stamp >= ``stamp`` (sensor-file sync convention,
        file_IO.cpp:285-294); streams forward, call with increasing stamps."""
        while True:
            e = self._next_entry()
            if e is None:
                return None
            s, q, p = e
            if s >= stamp:
                self._pending = (s, q, p)
                return PoseData(position=p, orientation=q, stamp=s)

    def read_all(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(stamps (N,), quats (N, 4) [w,x,y,z], positions (N, 3))."""
        stamps, quats, poss = [], [], []
        while True:
            e = self._next_entry()
            if e is None:
                break
            stamps.append(e[0])
            quats.append(e[1])
            poss.append(e[2])
        return (np.asarray(stamps, np.int64), np.asarray(quats),
                np.asarray(poss))

    def pose_at(self, stamps, query: int) -> PoseData:
        """Interpolated pose at ``query`` from read_all() output ``stamps`` =
        (stamps, quats, positions): linear position, slerp orientation;
        clamps outside the covered range."""
        ts, quats, poss = stamps
        i = int(np.searchsorted(ts, query))
        if i <= 0:
            return PoseData(position=poss[0], orientation=quats[0],
                            stamp=int(ts[0]))
        if i >= len(ts):
            return PoseData(position=poss[-1], orientation=quats[-1],
                            stamp=int(ts[-1]))
        t0, t1 = ts[i - 1], ts[i]
        a = (query - t0) / max(t1 - t0, 1)
        pos = (1 - a) * poss[i - 1] + a * poss[i]
        q0, q1 = quats[i - 1], quats[i - 1 + 1]
        dot = float(np.dot(q0, q1))
        q1s = q1 if dot >= 0 else -q1
        dot = abs(dot)
        if dot > 0.9995:  # nearly parallel: lerp
            q = (1 - a) * q0 + a * q1s
        else:
            th = np.arccos(np.clip(dot, -1.0, 1.0))
            q = (np.sin((1 - a) * th) * q0 + np.sin(a * th) * q1s) / np.sin(th)
        q = q / np.linalg.norm(q)
        return PoseData(position=pos, orientation=q, stamp=int(query))

    def positions(self) -> np.ndarray:
        return self.read_all()[2]

    def close(self):
        self._fh.close()


# phase-congruency plane suffixes (loadPCImage[s], file_IO.cpp:366-398)
PC_PLANES = ("M", "m", "PC", "ft")


def load_pc_image(directory: str, cam: int, idx: int, padding: int = 5
                  ) -> np.ndarray:
    """Load a 4-plane phase-congruency image as (4, H, W) float32 in [0, 1]
    (loadPCImage, file_IO.cpp:386-398): planes M, m, PC, ft."""
    import cv2

    planes = []
    for suffix in PC_PLANES:
        path = os.path.join(
            directory, f"cam{cam}_image{idx:0{padding}d}_{suffix}.png"
        )
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        planes.append(img.astype(np.float32) / 255.0)
    return np.stack(planes)


def load_pc_images(directory: str, idx: int, padding: int = 5
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Stereo pair of 4-plane PC images, each (4, H, W)
    (loadPCImages, file_IO.cpp:366-384)."""
    return (load_pc_image(directory, 0, idx, padding),
            load_pc_image(directory, 1, idx, padding))


class RunController:
    """Headless pause/resume/quit control — the reference's keyboard
    IOSigHandler ('p' pause, 'r' resume, 'q' quit; file_IO.h:159-182)
    re-imagined for jobs without a window: a control FILE is polled between
    frames; writing "pause"/"resume"/"quit" into it drives the session, and
    SIGINT requests a clean quit."""

    def __init__(self, control_file: str | None = None, poll_s: float = 0.25):
        import signal

        self.control_file = control_file
        self.poll_s = poll_s
        self.quit_requested = False
        try:
            signal.signal(signal.SIGINT, self._on_sigint)
        except ValueError:
            pass  # not the main thread; file control still works

    def _on_sigint(self, *_):
        self.quit_requested = True

    def _read_command(self) -> str:
        if not self.control_file or not os.path.exists(self.control_file):
            return ""
        with open(self.control_file) as fh:
            return fh.read().strip().lower()

    def checkpoint(self) -> bool:
        """Call between frames. Blocks while paused; returns False when the
        session should stop."""
        import time

        while True:
            if self.quit_requested:
                return False
            cmd = self._read_command()
            if cmd == "quit":
                return False
            if cmd == "pause":
                time.sleep(self.poll_s)
                continue
            return True
