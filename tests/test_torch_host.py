"""The port's host modules against JAX's, and its examples.

- ``utils/io.py`` and ``utils/sensors.py``: each case of tests/test_io.py
  (yml load and legacy keys, CSV header discovery, IMU average-to-stamp and
  pose sync, KITTI and generic layouts with crop and skip, GPS, the image
  stamp file and a video synced to it, ground truth, the PC planes, ``RunController``) runs through
  the port's modules and JAX's on the same temporary files, and the two
  give equal results.
- ``utils/viz.py``: every plot writes its PNG; ``covariance_ellipse``
  returns JAX's numbers.
- ``utils/profiling.py``: ``StageTimer``'s counts and totals, and ``trace``
  writing a Chrome trace with a program span in it.
- ``native/``: the loader, built with g++ into ``_build/``, gives the
  frames of the port's ``ImageSequenceReader`` (skips where cv2 or
  OpenCV's headers are absent, as tests/test_native.py does).
- ``examples/run_synthetic_torch.run(12, tmp, "cpu")``: ATE < 0.1 m; and
  ``examples/run_dataset_torch.py`` on a KITTI-layout directory of those
  frames writes its trajectory.
"""

import dataclasses
import enum
import importlib.util
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from uasl_motion_estimation_tpu_torch.utils import io as tio
from uasl_motion_estimation_tpu_torch.utils import profiling, sensors as tsensors

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

YML = """%YAML:1.0
---
dataset:
   dir: "/data/seq00"
   type: "stereo"
   gt: "gt.csv"
frames:
   start: 10
   stop: 100
   skip: 2
tracking:
   feats: 300
   window: 7
   ba_rate: 3
calib:
   f1: 718.856
   f2: 718.856
   cu: 607.19
   cv: 185.22
   baseline: 0.5372
   ransac: "true"
   threshold: 1.5
   method: "GN"
appendix: "ir"
"""
LEGACY_YML = """%YAML:1.0
---
dataset:
   type: "stereo"
calib:
   fu1: 400.
   fu2: 410.
   fv1: 401.
   fv2: 411.
   cu1: 320.
   cu2: 321.
   cv1: 240.
   cv2: 241.
   baseline: 0.3
"""


def plain(x):
    """Dataclasses, enums, arrays and containers as comparable plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):  # each package has its own enum classes
        return (type(x).__name__, x.value)
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def write_images(d, names, shape, seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    for name in names:
        cv2.imwrite(str(d / name), rng.integers(0, 255, shape, np.uint8))


def case_yml(uio, sensors, d):
    (d / "config.yml").write_text(YML)
    (d / "legacy.yml").write_text(LEGACY_YML)
    return uio.load_yml(str(d / "config.yml")), uio.load_yml(str(d / "legacy.yml"))


def case_csv_header(uio, sensors, d):
    (d / "data.csv").write_text("# timestamp, x, y, z\n1, 1.0, 2.0, 3.0\n2, 4.0, 5.0, 6.0\n")
    (d / "bad.csv").write_text("1, 2, 3\n")
    f = uio.CsvFile(str(d / "data.csv"))
    with pytest.raises(ValueError):
        uio.CsvFile(str(d / "bad.csv"))
    return f.columns, list(f.rows())


def case_imu_pose_sync(uio, sensors, d):
    (d / "imu.csv").write_text(
        "# timestamp, acc_x, acc_y, acc_z, av_x, av_y, av_z\n"
        "1, 1, 0, 0, 0.1, 0, 0\n2, 2, 0, 0, 0.2, 0, 0\n3, 3, 0, 0, 0.3, 0, 0\n"
        "10, 9, 0, 0, 0.9, 0, 0\n")
    (d / "pose.csv").write_text("# timestamp, x, y, z\n1, 0, 0, 0\n5, 1, 0, 0\n9, 2, 0, 0\n")
    (d / "gps.csv").write_text("# timestamp, lat, lon, alt\n1, 52.0, -0.5, 10\n4, 52.1, -0.4, 11\n")
    imu = uio.ImuFile(str(d / "imu.csv"))
    pose = uio.PoseFile(str(d / "pose.csv"))
    gps = uio.GpsFile(str(d / "gps.csv"))
    return (imu.get_next(5), imu.get_next(20), pose.get_next(4), pose.get_next(9),
            gps.get_next(2))


def case_kitti_layout(uio, sensors, d):
    write_images(d, [f"{c}_{i:06d}.png" for i in range(6) for c in "LR"], (400, 200), 0)
    rd = uio.ImageSequenceReader(str(d))
    skip = uio.ImageSequenceReader(str(d), uio.FrameConfig(start=1, stop=5, skip=2))
    return rd.read_frame(0), list(rd), list(skip)


def case_generic_layout(uio, sensors, d):
    write_images(d, [f"cam{c}_image{i:05d}_ir.png" for i in (7, 8) for c in (0, 1)],
                 (40, 60), 1)
    rd = uio.ImageSequenceReader(str(d), appendix="ir")
    return rd.read_frame(7), rd.read_frame(8)


def case_gps(uio, sensors, d):
    f = sensors.GpsFrame(origin_lat=52.0, origin_lon=-0.5)
    g = sensors.GpsFrame(origin_lat=52.0, origin_lon=0.0, angle=0.3)
    a = sensors.ImuData(acc=np.array([1.0, 0, 0]), stamp=1)
    a += sensors.ImuData(acc=np.array([3.0, 0, 0]), gyr=np.array([0.0, 1.0, 0.0]), stamp=2)
    a /= 2
    return f.to_cartesian(52.0, -0.5), f.to_cartesian(53.0, -0.2), g.to_cartesian(52.3, 0.4), a


def case_stamp_file_and_gt(uio, sensors, d):
    (d / "image_data.csv").write_text("#number,timestamp\n0,100\n1,110\n2,120\n")
    stamps = uio.ImageStampFile(str(d / "image_data.csv"))
    lines = ["# timestamp, qx, qy, qz, qw, x, y, z"]
    lines += [f"{1000 + 10 * i}, 0.0, 0.0, {0.1 * i}, 1.0, {float(i)}, {2.0 * i}, 0.5"
              for i in range(5)]
    (d / "gt.csv").write_text("\n".join(lines) + "\n")
    rd = uio.GTReader(str(d / "gt.csv"))
    try:
        got = [stamps.read_next() for _ in range(4)]
        got += [rd.read_pose_line(), rd.get_next(1015), rd.get_next(1020), rd.get_next(1031),
                rd.get_next(9999)]
    finally:
        rd.close()
    rd = uio.GTReader(str(d / "gt.csv"))
    try:
        table = rd.read_all()
        got += [table, rd.pose_at(table, 1015), rd.pose_at(table, 0), rd.pose_at(table, 99999)]
    finally:
        rd.close()
    rd = uio.GTReader(str(d / "gt.csv"))
    try:
        got.append(rd.positions())
    finally:
        rd.close()
    return got


def case_pc_images(uio, sensors, d):
    cv2 = pytest.importorskip("cv2")
    for cam in (0, 1):
        for i, sfx in enumerate(uio.PC_PLANES):
            cv2.imwrite(str(d / f"cam{cam}_image00003_{sfx}.png"),
                        np.full((20, 30), 40 * i + cam, np.uint8))
    return uio.load_pc_images(str(d), 3)


def case_run_controller(uio, sensors, d):
    previous = signal.getsignal(signal.SIGINT)
    try:
        ctl = d / "control"
        rc = uio.RunController(str(ctl), poll_s=0.01)
        got = [rc.checkpoint()]
        ctl.write_text("quit")
        got.append(rc.checkpoint())
        ctl.write_text("resume")
        got.append(rc.checkpoint())
        rc._on_sigint()
        got.append(rc.checkpoint())
    finally:
        signal.signal(signal.SIGINT, previous)
    return got


def case_video_stamp_sync(uio, sensors, d):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(d / "cam0_image.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (48, 32), isColor=True)
    if not vw.isOpened():
        pytest.skip("no video codec available in this cv2 build")
    for i in range(6):
        vw.write(np.full((32, 48, 3), 10 * i, np.uint8))
    vw.release()
    (d / "image_data.csv").write_text(
        "#number,timestamp\n" + "".join(f"{i},{1000 + 10 * i}\n" for i in range(6)))
    rd = uio.VideoSequenceReader(str(d), uio.FrameConfig(skip=2), stereo=False,
                                 stamp_file=str(d / "image_data.csv"))
    try:
        frame = rd.read_frame()
        return frame, rd.img_nb, rd.img_stamp, rd.is_valid()
    finally:
        rd.close()


CASES = [case_yml, case_csv_header, case_imu_pose_sync, case_kitti_layout, case_generic_layout,
         case_gps, case_stamp_file_and_gt, case_video_stamp_sync, case_pc_images,
         case_run_controller]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_io_and_sensors_match_jax(case, tmp_path):
    from uasl_motion_estimation_tpu.utils import io as jio
    from uasl_motion_estimation_tpu.utils import sensors as jsensors

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = plain(case(jio, jsensors, tmp_path / "jax"))
    got = plain(case(tio, tsensors, tmp_path / "port"))
    assert got == want


def test_run_controller_pauses_until_resumed(tmp_path):
    import threading

    previous = signal.getsignal(signal.SIGINT)
    try:
        ctl = tmp_path / "control"
        ctl.write_text("pause")
        rc = tio.RunController(str(ctl), poll_s=0.01)
        result = {}
        th = threading.Thread(target=lambda: result.update(ok=rc.checkpoint()))
        th.start()
        time.sleep(0.05)
        assert th.is_alive()
        ctl.write_text("resume")
        th.join(timeout=2.0)
        assert not th.is_alive() and result.get("ok") is True
    finally:
        signal.signal(signal.SIGINT, previous)


VIZ = {
    "plot_trajectories": lambda v, rng, p: v.plot_trajectories(
        {"est": np.cumsum(rng.normal(size=(20, 3)), 0), "gt": np.zeros((20, 3))}, path=p),
    "plot_metrics": lambda v, rng, p: v.plot_metrics(
        [{"frame": i, "n_matches": 100 - i, "n_inliers": 90 - i, "mean_reproj_error": 0.1 * i,
          "n_tracks": 50} for i in range(10)], path=p),
    "draw_tracks": lambda v, rng, p: v.draw_tracks(
        rng.uniform(0, 255, (100, 200)), rng.uniform(10, 90, (30, 2)), np.ones(30, bool),
        depths=rng.uniform(5, 50, 30), path=p),
    "draw_stereo_reprojection": lambda v, rng, p: v.draw_stereo_reprojection(
        rng.uniform(0, 255, (100, 200)), *(2 * [rng.uniform(10, 90, (30, 2))]),
        np.ones(30, bool), path=p),
    "plot_trajectory_3d": lambda v, rng, p: v.plot_trajectory_3d(
        {"est": np.cumsum(rng.normal(size=(15, 3)), 0)}, path=p),
    "plot_joint_distribution": lambda v, rng, p: v.plot_joint_distribution(
        *(2 * [rng.uniform(0, 255, (16, 16))]), path=p),
    "plot_covariances": lambda v, rng, p: v.plot_covariances(
        np.cumsum(rng.normal(size=(10, 3)), 0), np.tile(np.eye(6) * 0.01, (10, 1, 1)), path=p),
}


@pytest.mark.parametrize("name", sorted(VIZ))
def test_viz_writes_its_png(name, tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from uasl_motion_estimation_tpu_torch.utils import viz

    path = tmp_path / f"{name}.png"
    fig = VIZ[name](viz, np.random.default_rng(0), str(path))
    plt.close(fig)
    assert path.stat().st_size > 0


def test_covariance_ellipse_matches_jax():
    from uasl_motion_estimation_tpu.utils import viz as jviz
    from uasl_motion_estimation_tpu_torch.utils import viz

    for cov in (np.diag([4.0, 1.0]), np.array([[2.0, 0.7], [0.7, 1.0]]), np.eye(2) * 1e-3):
        assert viz.covariance_ellipse(cov) == jviz.covariance_ellipse(cov)


def test_stage_timer_counts_and_totals():
    t = profiling.StageTimer()
    for _ in range(2):
        with t("a"):
            time.sleep(0.01)
    with t("b"):
        pass
    assert dict(t.counts) == {"a": 2, "b": 1}
    assert t.totals["a"] >= 0.02 and t.totals["b"] < t.totals["a"]
    rep = t.report()
    assert rep.splitlines()[0].startswith("a") and "x2" in rep and "x1" in rep


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        with profiling.span("stage"):
            torch.ones(8).sum()
    assert '"stage"' in path.read_text()


@pytest.fixture
def kitti_dir(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for i in range(5):
        img = rng.integers(0, 255, (380, 120), np.uint8)
        cv2.imwrite(str(tmp_path / f"L_{i:06d}.png"), img)
        cv2.imwrite(str(tmp_path / f"R_{i:06d}.png"), img // 2)
    return tmp_path


def native_loader():
    from uasl_motion_estimation_tpu_torch import native

    if not (native.build_native() and native.native_available()):
        pytest.skip("native loader not buildable here (g++ or OpenCV's headers missing)")
    assert native.loader.library_path().parent.name == "_build"
    return native


def test_native_loader_matches_python_reader(kitti_dir):
    native = native_loader()
    with native.AsyncFrameLoader(str(kitti_dir)) as fl:
        frames = list(fl)
    ref = list(tio.ImageSequenceReader(str(kitti_dir)))
    assert [idx for idx, _, _ in frames] == list(range(5)) and len(ref) == 5
    for (_, left, right), (lp, rp) in zip(frames, ref):
        assert left.shape == (374, 120)
        np.testing.assert_array_equal(left, lp)
        np.testing.assert_array_equal(right, rp)
    with native.AsyncFrameLoader(str(kitti_dir), start=1, stop=4, skip=2) as fl:
        assert [idx for idx, _, _ in fl] == [1, 3]
    fl = native.AsyncFrameLoader(str(kitti_dir), queue_depth=1)
    next(iter(fl))
    fl.close()  # the worker is mid-queue
    with native.AsyncFrameLoader(str(kitti_dir / "missing")) as fl:
        assert list(fl) == []


def load_example(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_synthetic_example(tmp_path):
    res = load_example("run_synthetic_torch").run(12, tmp_path, "cpu")
    assert res["trajectory"].shape == (12, 4, 4)
    assert res["ate_m"] < 0.1, res["ate_m"]
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 12


def test_run_dataset_example(tmp_path):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    from uasl_motion_estimation_tpu_torch.utils import synthetic

    rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                              height=192, width=320)
    seq = synthetic.SyntheticStereoSequence(n_frames=4, rig=rig, seed=4)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(4):
        for cam, img in zip("LR", seq.frame(i)):
            cv2.imwrite(str(data / f"{cam}_{i:06d}.png"), np.clip(img, 0, 255).astype(np.uint8))
    (tmp_path / "config.yml").write_text(
        f'%YAML:1.0\n---\ndataset:\n   dir: "{data}"\n   type: "stereo"\nframes:\n   start: 0\n'
        f'   stop: 3\n   skip: 1\ntracking:\n   feats: 128\n   window: 3\n   ba_rate: 2\n'
        f'calib:\n   f1: 320.\n   f2: 320.\n   cu: 160.\n   cv: 96.\n   baseline: 0.54\n')
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, str(REPO / "examples" / "run_dataset_torch.py"),
                           str(tmp_path / "config.yml"), str(out), "--device", "cpu"],
                          capture_output=True, text=True, timeout=300,
                          env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    traj = np.loadtxt(out / "trajectory.txt")
    assert traj.shape == (4, 12) and np.isfinite(traj).all()
    assert (out / "trajectory.png").exists()
