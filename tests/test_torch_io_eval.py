"""The port's dataset surfaces against the JAX package's: the copied
trajectory files (io/trajectory), evaluation metrics (utils/evaluation)
and rosbag reader (io/rosbag), the EuRoC and KITTI readers on the fixtures
of tests/test_io_eval.py, a synthetic D435i RGB-D bag, the synthetic
EuRoC-format stereo + IMU run of tests/test_pipeline.py:314-368 through the
port's stepwise and chunked VIO (its bounds: ATE < 0.02 m each, the two
trajectories within 2e-3), and `python -m flvis_tpu_torch.run_dataset` in
depth mode on that bag.

Readers and metrics are numpy on both sides: equal arrays (camera and
extrinsic tensors within 1e-6)."""

import struct

import numpy as np
import pytest
import torch

import flvis_tpu_torch.config as tconfig
from flvis_tpu.io import euroc as jeuroc, kitti as jkitti, rosbag as jrosbag
from flvis_tpu.io import trajectory as jtraj
from flvis_tpu.utils import evaluation as jeval
from flvis_tpu_torch import run_dataset
from flvis_tpu_torch.io import euroc as teuroc, kitti as tkitti, rosbag as trosbag
from flvis_tpu_torch.io import native_loader as tnative
from flvis_tpu_torch.io import trajectory as ttraj
from flvis_tpu_torch.io.synthetic import (PlanarScene, SceneConfig, export_euroc_sequence,
                                          orbit_trajectory)
from flvis_tpu_torch.pipeline.runner import SlamSystem
from flvis_tpu_torch.utils import evaluation as teval, profiling, timing
from test_io_eval import make_euroc_fixture, make_kitti_fixture
from test_rosbag import _header, _image_msg, _imu_msg, _record, _time

torch.set_num_threads(1)


def _poses(rng, n):
    from scipy.spatial.transform import Rotation

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, rng).as_matrix()
    T[:, :3, 3] = rng.normal(size=(n, 3))
    return T


def test_tum_files_match(tmp_path):
    rng = np.random.default_rng(0)
    ts = np.arange(10) * 0.05
    pos = rng.normal(size=(10, 3))
    q = rng.normal(size=(10, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ttraj.write_tum(tmp_path / "t.tum", ts, pos, q)
    jtraj.write_tum(tmp_path / "j.tum", ts, pos, q)
    assert (tmp_path / "t.tum").read_text() == (tmp_path / "j.tum").read_text()
    for a, b in zip(ttraj.read_tum(tmp_path / "t.tum"), jtraj.read_tum(tmp_path / "t.tum")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ttraj.read_tum(tmp_path / "t.tum")[1], pos, atol=1e-5)


def test_kitti_files_match(tmp_path):
    poses = _poses(np.random.default_rng(1), 5)
    ttraj.write_kitti(tmp_path / "t.kitti", poses)
    jtraj.write_kitti(tmp_path / "j.kitti", poses)
    assert (tmp_path / "t.kitti").read_text() == (tmp_path / "j.kitti").read_text()
    np.testing.assert_array_equal(ttraj.read_kitti(tmp_path / "t.kitti"),
                                  jtraj.read_kitti(tmp_path / "t.kitti"))
    np.testing.assert_allclose(ttraj.read_kitti(tmp_path / "t.kitti"), poses, atol=1e-5)


def _metric_cases():
    rng = np.random.default_rng(2)
    gt = np.cumsum(rng.normal(size=(60, 3)) * 0.1, axis=0)
    est = 1.3 * gt @ _poses(rng, 1)[0, :3, :3].T + 0.5 + rng.normal(scale=0.05, size=gt.shape)
    pe, pg = _poses(rng, 20), _poses(rng, 20)
    ta = np.sort(rng.uniform(0, 3, 40))
    tb = np.sort(rng.uniform(0, 3, 30))
    return {"associate": ((ta, tb), {"max_dt": 0.05}),
            "umeyama_alignment": ((est, gt), {"with_scale": True}),
            "ate_rmse": ((est, gt), {}),
            "rpe": ((pe, pg), {"delta": 3})}


@pytest.mark.parametrize("name", ["associate", "umeyama_alignment", "ate_rmse", "rpe"])
def test_evaluation_matches(name):
    args, kw = _metric_cases()[name]
    got, want = getattr(teval, name)(*args, **kw), getattr(jeval, name)(*args, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_euroc_reader_matches(tmp_path):
    make_euroc_fixture(tmp_path)
    jd, td = jeuroc.EurocDataset(str(tmp_path)), teuroc.EurocDataset(str(tmp_path),
                                                                      device="cpu")
    for f in ("fx", "fy", "cx", "cy", "baseline"):
        np.testing.assert_allclose(float(getattr(td.camera, f)),
                                   float(getattr(jd.camera, f)), atol=1e-6)
    assert (td.camera.width, td.camera.height) == (jd.camera.width, jd.camera.height)
    np.testing.assert_allclose(td.T_i_c.q.numpy(), np.asarray(jd.T_i_c.q), atol=1e-6)
    np.testing.assert_allclose(td.T_i_c.t.numpy(), np.asarray(jd.T_i_c.t), atol=1e-6)
    for a in ("frame_ts", "imu_t", "imu_acc", "imu_gyro", "gt_t", "gt_pos", "gt_quat_wxyz"):
        np.testing.assert_array_equal(getattr(td, a), getattr(jd, a))
    tf, jf = list(td.frames()), list(jd.frames())
    assert len(tf) == len(jf) == 4
    for a, b in zip(tf, jf):
        for f in ("img0", "img1", "imu_t", "imu_acc", "imu_gyro"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.t == b.t


def test_kitti_reader_matches(tmp_path):
    make_kitti_fixture(tmp_path)
    poses = str(tmp_path / "poses.txt")
    jd = jkitti.KittiDataset(str(tmp_path), poses_file=poses)
    td = tkitti.KittiDataset(str(tmp_path), poses_file=poses, device="cpu")
    np.testing.assert_allclose(float(td.camera.baseline), float(jd.camera.baseline), atol=1e-6)
    np.testing.assert_array_equal(td.gt_poses, jd.gt_poses)
    tf, jf = list(td.frames()), list(jd.frames(use_native=False))
    assert len(tf) == len(jf) == 3
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.img0, b.img0)
        np.testing.assert_array_equal(a.img1, b.img1)
        assert a.t == b.t
    # frames() decodes with the native loader (built here: g++ and libpng
    # headers are present); its frames equal cv2's exactly.
    assert tnative.available(), tnative.build_error()
    for a, b in zip(td.frames(use_native=True), td.frames(use_native=False)):
        np.testing.assert_array_equal(a.img0, b.img0)
        np.testing.assert_array_equal(a.img1, b.img1)
        assert a.img0.dtype == b.img0.dtype == np.float32 and a.t == b.t


def test_native_decoder_matches_cv2(tmp_path):
    """io/native_loader: decode_png_gray and the stereo prefetcher against
    cv2 on 8-bit gray PNGs (exact), and a 16-bit gray PNG (stripped to its
    high byte)."""
    import cv2

    rng = np.random.default_rng(4)
    g8 = rng.integers(0, 256, (37, 53), np.uint8)
    cv2.imwrite(str(tmp_path / "g8.png"), g8)
    got = tnative.decode_png_gray(str(tmp_path / "g8.png"))
    np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "g8.png"),
                                                  cv2.IMREAD_GRAYSCALE).astype(np.float32))
    assert got.dtype == np.float32 and got.shape == (37, 53)
    g16 = rng.integers(0, 65536, (20, 30), np.uint16)
    cv2.imwrite(str(tmp_path / "g16.png"), g16)
    np.testing.assert_array_equal(tnative.decode_png_gray(str(tmp_path / "g16.png")),
                                  (g16 >> 8).astype(np.float32))
    assert tnative.decode_png_gray(str(tmp_path / "missing.png")) is None
    paths = [str(tmp_path / "g8.png")] * 3
    pf = tnative.StereoPrefetcher(paths, paths, 53, 37)
    frames = list(pf)
    pf.close()
    assert len(frames) == 3
    for a, b in frames:
        np.testing.assert_array_equal(a, got)
        np.testing.assert_array_equal(b, got)


SCFG = SceneConfig(width=256, height=192, fx=200.0, fy=200.0, cx=128.0, cy=96.0,
                   baseline=0.12)


def _rgbd_bag(path, n, compression="none"):
    """A D435i-style bag of n RGB-D frames of SCFG's planar scene along an
    orbit (mono8 infra image, 16UC1 aligned depth in mm, 200 Hz IMU at
    rest): the frames' ground-truth camera centres."""
    scene = PlanarScene(SCFG, plane_depth=6.0, seed=3)
    poses = orbit_trajectory(n, step=0.03)
    conns = {0: ("/camera/infra1/image_rect_raw", "sensor_msgs/Image"),
             1: ("/camera/aligned_depth_to_color/image_raw", "sensor_msgs/Image"),
             2: ("/camera/imu", "sensor_msgs/Imu")}
    chunk = b""
    for cid, (topic, mtype) in conns.items():
        chunk += _record({"op": b"\x07", "conn": struct.pack("<I", cid),
                          "topic": topic.encode()},
                         _header({"type": mtype.encode(), "topic": topic.encode(),
                                  "md5sum": b"0" * 32, "message_definition": b""}))
    for i, (R, t) in enumerate(poses):
        ts = 10.0 + 0.05 * i
        for k in range(10):
            ti = ts - 0.05 + 0.005 * (k + 1)
            chunk += _record({"op": b"\x02", "conn": struct.pack("<I", 2), "time": _time(ti)},
                             _imu_msg(ti, [0.0, 0.0, 0.0], [0.0, 0.0, 9.81]))
        img, _, depth = scene.render(R, t)
        for cid, msg in ((0, _image_msg(ts, np.clip(np.round(img), 0, 255))),
                         (1, _image_msg(ts, np.round(depth * 1000.0), encoding="16UC1"))):
            chunk += _record({"op": b"\x02", "conn": struct.pack("<I", cid), "time": _time(ts)},
                             msg)
    payload = chunk
    if compression == "bz2":
        import bz2

        payload = bz2.compress(chunk)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record({"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                         "conn_count": struct.pack("<I", 3),
                         "chunk_count": struct.pack("<I", 1)}, b"\x00" * 64))
        f.write(_record({"op": b"\x05", "compression": compression.encode(),
                         "size": struct.pack("<I", len(chunk))}, payload))
    return np.asarray([-R.T @ t for (R, t) in poses])


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_d435i_bag_matches(tmp_path, compression):
    p = str(tmp_path / "d.bag")
    _rgbd_bag(p, 3, compression)
    topics = ("/camera/infra1/image_rect_raw", "/camera/aligned_depth_to_color/image_raw")
    tf, jf = list(trosbag.d435i_frames(p, *topics)), list(jrosbag.d435i_frames(p, *topics))
    assert len(tf) == len(jf) == 3
    for a, b in zip(tf, jf):
        for f in ("img0", "img1", "imu_t", "imu_acc", "imu_gyro"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.t == b.t
    assert tf[0].img1.dtype == np.float32 and 5000 < tf[0].img1.mean() < 7000


def test_run_dataset_d435i_depth(tmp_path, capsys):
    """run_dataset over an RGB-D bag in depth mode: a TUM file of every
    frame, every frame after the first tracked, within the tracker's ATE
    bound (tests/test_tracker.py:97)."""
    n = 6
    C_gt = _rgbd_bag(str(tmp_path / "d.bag"), n)
    out = tmp_path / "est.tum"
    assert run_dataset.main([
        "d435i", str(tmp_path / "d.bag"), "--depth",
        "--img1", "/camera/aligned_depth_to_color/image_raw", "--fx", "200", "--fy", "200",
        "--cx", "128", "--cy", "96", "--width", "256", "--height", "192",
        "--out", str(out), "--device", "cpu"]) == 0
    assert "TRACK" in capsys.readouterr().out
    ts, C, q = ttraj.read_tum(out)
    assert C.shape == (n, 3) and np.isfinite(C).all()
    np.testing.assert_allclose(np.diff(ts), 0.05, atol=1e-5)
    err, _ = teval.ate_rmse(C, C_gt, align=False)
    assert err < 0.02 * 0.03 * n + 0.01, err


@pytest.fixture(scope="module")
def euroc_runs(tmp_path_factory):
    """tests/test_pipeline.py:314-368 through the port: the synthetic
    EuRoC-format sequence, read by the port's EurocDataset, stepwise
    (feed_imu + process_frame) and in chunks of 8 (process_frames_vio)."""
    root = str(tmp_path_factory.mktemp("euroc"))
    export_euroc_sequence(root, num_frames=16, seed=6)
    ds = teuroc.EurocDataset(root, device="cpu")
    frames = list(ds.frames())
    cam = ds.camera
    cfg = tconfig.SystemConfig(
        frontend=tconfig.FrontendConfig(width=cam.width, height=cam.height, num_slots=128,
                                        pyramid_levels=3, per_cell=8, min_distance=12.0,
                                        margin=22),
        backend=tconfig.BackendConfig(window_size=5, max_landmarks=256, iters1=6, iters2=3))
    sys_a = SlamSystem(cfg, cam, device="cpu", T_i_c=ds.T_i_c, use_imu=True)
    for fr in frames:
        if len(fr.imu_t):
            sys_a.feed_imu(fr.imu_acc, fr.imu_gyro, fr.imu_t)
        sys_a.process_frame(fr.img0, fr.img1, t_img=fr.t)
    sys_b = SlamSystem(cfg, cam, device="cpu", T_i_c=ds.T_i_c, use_imu=True)
    calls = profiling.totals().get("chunk", {}).get("calls", 0)
    for c0 in range(0, len(frames), 8):
        b = frames[c0:c0 + 8]
        sys_b.process_frames_vio(
            np.stack([f.img0 for f in b]), np.stack([f.img1 for f in b]),
            ts=np.asarray([f.t for f in b]), imu_acc=[f.imu_acc for f in b],
            imu_gyro=[f.imu_gyro for f in b], imu_t=[f.imu_t for f in b])
    return ds, sys_a, sys_b, profiling.totals()["chunk"]["calls"] - calls


def _ate(ds, sys_):
    ts = np.asarray([t for (_, t, _, _) in sys_.trajectory])
    ia, ib = teval.associate(ts, ds.gt_t)
    assert len(ia) == len(ts)
    return teval.ate_rmse(sys_.trajectory_cam_centers()[ia], ds.gt_pos[ib])[0]


def test_euroc_format_vio_ate(euroc_runs):
    ds, sys_a, sys_b, _ = euroc_runs
    ate_a, ate_b = _ate(ds, sys_a), _ate(ds, sys_b)
    assert ate_a < 0.02, f"stepwise VIO ATE {ate_a:.4f} m"
    assert ate_b < 0.02, f"chunked VIO ATE {ate_b:.4f} m"


def test_euroc_format_stepwise_and_chunked_agree(euroc_runs):
    _, sys_a, sys_b, chunks = euroc_runs
    ta = np.asarray([t for (_, _, _, t) in sys_a.trajectory])
    tb = np.asarray([t for (_, _, _, t) in sys_b.trajectory])
    assert ta.shape == tb.shape == (16, 3)
    np.testing.assert_allclose(ta, tb, atol=2e-3)
    assert chunks == 2 and "chunk" in profiling.report()


def test_timing_sync_on_cpu_tensors():
    """timing.sync takes any record of tensors and waits only on CUDA
    devices: nothing to wait for on the CPU."""
    from flvis_tpu_torch.geometry import se3

    assert timing.sync({"a": torch.ones(3), "T": se3.identity(device="cpu")}) is None
    n = profiling.sites().get("test.x", (0, 0))[0]
    assert profiling.host_read(torch.zeros(2), site="test.x").shape == (2,)
    assert profiling.sites()["test.x"][0] == n + 1
