"""viz/cloud and viz/overlay of the port against the JAX package's: each of
tests/test_viz.py's seven cases through both, with that test's own
assertions on the port.

Tolerances: voxel_downsample's voxels in the same order, centroids within
1e-6 m (the port sums each voxel in float64 in a fixed tree order, the
reference in float32 in point order) and the same mask; write_ply and the
overlay functions byte-equal on the same numpy inputs; what is computed
from poses (depth-band points, marker vertices) within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from flvis_tpu.viz import cloud as jcloud, overlay as joverlay
from flvis_tpu_torch.geometry import camera as tcam, se3 as tse3, so3 as tso3
from flvis_tpu_torch.viz import cloud as tcloud, overlay as toverlay

torch.set_num_threads(1)


def _voxels_both(pts, mask, leaf=0.08):
    jo, jm = jcloud.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), leaf=leaf)
    to, tm = tcloud.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask), leaf=leaf)
    jo, jm = np.asarray(jo), np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(to.numpy()[jm], jo[jm], atol=1e-6, rtol=0)
    return to.numpy()[tm.numpy()]


def test_voxel_downsample_merges_within_leaf():
    pts = np.asarray(
        [[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [0.03, 0.01, 0.02],
         [5.0, 5.0, 5.0], [5.01, 5.01, 5.01],
         [99.0, 99.0, 99.0]], np.float32)
    mask = np.asarray([1, 1, 1, 1, 1, 0], bool)
    got = _voxels_both(pts, mask)
    assert len(got) == 2
    np.testing.assert_allclose(got[0], pts[:3].mean(0), atol=1e-5)
    np.testing.assert_allclose(got[1], pts[3:5].mean(0), atol=1e-5)


def test_voxel_downsample_negative_coords():
    pts = np.asarray([[-0.01, -0.01, -0.01], [-0.02, -0.02, -0.02],
                      [0.5, 0.5, 0.5]], np.float32)
    assert len(_voxels_both(pts, np.ones(3, bool))) == 2


@pytest.mark.parametrize("n,leaf", [(2048, 0.08), (777, 0.5)])
def test_voxel_downsample_order_random_cloud(n, leaf):
    """A random cloud with shared voxels, negative cells and invalid points:
    the reference's voxel order and centroids."""
    rng = np.random.default_rng(n)
    pts = (rng.normal(size=(n, 3)) * np.asarray([3.0, 1.0, 0.5])).astype(np.float32)
    pts[n // 2:] = pts[:n - n // 2] + rng.normal(scale=0.01, size=(n - n // 2, 3))
    mask = rng.uniform(size=n) > 0.2
    got = _voxels_both(pts.astype(np.float32), mask, leaf)
    assert 0 < len(got) < mask.sum()


def test_sparse_map_recorder_latest_position_wins(tmp_path):
    outs = {}
    for name, mod in (("t", tcloud), ("j", jcloud)):
        rec = (mod.SparseMapRecorder(leaf=0.05, device="cpu") if mod is tcloud
               else mod.SparseMapRecorder(leaf=0.05))
        rec.add_correction(np.asarray([100, 101]), np.asarray([[0, 0, 1.0], [3, 0, 1.0]]),
                           np.asarray([True, True]))
        rec.add_correction(np.asarray([100]), np.asarray([[10.0, 0, 1.0]]),
                           np.asarray([True]))
        pts = rec.cloud()
        assert len(pts) == 2
        assert np.any(np.linalg.norm(pts - np.asarray([10.0, 0, 1.0]), axis=1) < 1e-4)
        assert rec.save_ply(str(tmp_path / f"{name}.ply")) == 2
        outs[name] = pts
    header = (tmp_path / "t.ply").read_text().splitlines()
    assert header[0] == "ply" and "element vertex 2" in header
    np.testing.assert_allclose(outs["t"], outs["j"], atol=1e-6)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_write_ply_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    mask = rng.uniform(size=20) > 0.3
    colors = rng.integers(0, 256, (20, 3)).astype(np.uint8)
    edges = rng.integers(0, 10, (7, 2))
    for kw in ({}, {"mask": mask, "colors": colors}, {"edges": edges}):
        nt = tcloud.write_ply(str(tmp_path / "t.ply"), torch.as_tensor(pts), **kw)
        nj = jcloud.write_ply(str(tmp_path / "j.ply"), pts, **kw)
        assert nt == nj
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_depth_band_cloud_range_gate():
    args = (100.0, 100.0, 64.0, 48.0)
    kw = dict(baseline=0.1, depth_factor=1000.0, width=128, height=96)
    tc = tcam.make(*args, **kw, device="cpu")
    jc = jcam.make(*args, **kw)
    d = np.full((96, 128), 2000.0, np.float32)     # 2 m everywhere
    d[:, :64] = 20000.0                            # left half out of range (20 m)
    T = tse3.SE3(tso3.exp(torch.tensor([0.0, 0.2, 0.1])), torch.tensor([0.3, -0.1, 0.5]))
    jT = jse3.SE3(jnp.asarray(T.q.numpy()), jnp.asarray(T.t.numpy()))
    pts_c, pts_w, ok = tcloud.depth_band_cloud(tc, d, T, step=7, lines=3)
    jpc, jpw, jok = jcloud.depth_band_cloud(jc, d, jT, step=7, lines=3)
    ok = ok.numpy()
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_allclose(pts_c.numpy()[ok, 2], 2.0, atol=1e-5)
    np.testing.assert_allclose(pts_c.numpy(), np.asarray(jpc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pts_w.numpy(), np.asarray(jpw), atol=1e-6, rtol=0)
    # Identity pose: world == camera frame.
    _, pw_i, _ = tcloud.depth_band_cloud(tc, d, tse3.identity(device="cpu"), step=7, lines=3)
    np.testing.assert_allclose(pw_i.numpy()[ok], pts_c.numpy()[ok], atol=1e-5)


def test_camera_pyramid_and_marker_ply(tmp_path):
    q = tso3.exp(torch.tensor([0.0, 0.3, 0.0]))
    T = tse3.SE3(q, torch.tensor([0.5, 0.0, 1.0]))
    jT = jse3.SE3(jso3.exp(jnp.asarray([0.0, 0.3, 0.0])), jnp.asarray([0.5, 0.0, 1.0]))
    verts, edges = tcloud.camera_pyramid_segments(T)
    jverts, jedges = jcloud.camera_pyramid_segments(jT)
    assert verts.shape == (5, 3) and edges.shape == (8, 2)
    np.testing.assert_allclose(verts, jverts, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_allclose(verts[0], tse3.inverse(T).t.numpy(), atol=1e-6)
    lm = np.asarray([[0, 0, 5.0], [1, 1, 5.0]], np.float32)
    lmask = np.asarray([True, False])
    lv, le = tcloud.landmark_segments(T, lm, lmask)
    jlv, jle = jcloud.landmark_segments(jT, lm, lmask)
    np.testing.assert_allclose(lv, jlv, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(le, jle)
    tcloud.save_frame_marker_ply(str(tmp_path / "frame.ply"), T, lm, lmask)
    jcloud.save_frame_marker_ply(str(tmp_path / "jframe.ply"), jT, lm, lmask)
    text = (tmp_path / "frame.ply").read_text()
    assert "element vertex 8" in text and "element edge 9" in text
    t_lines, j_lines = text.splitlines(), (tmp_path / "jframe.ply").read_text().splitlines()
    assert len(t_lines) == len(j_lines)
    head = t_lines.index("end_header") + 1
    assert t_lines[:head] == j_lines[:head] and t_lines[-9:] == j_lines[-9:]
    tv = np.asarray([list(map(float, r.split())) for r in t_lines[head:head + 8]])
    jv = np.asarray([list(map(float, r.split())) for r in j_lines[head:head + 8]])
    np.testing.assert_allclose(tv, jv, atol=1e-4 + 1e-6)     # printed to 4 decimals


def test_overlay_draw_frame_colors():
    uv = np.asarray([[20.0, 30.0], [100.0, 60.0], [500.0, 500.0]])
    z = np.asarray([0.5, 10.0, 3.0])
    mask = np.asarray([True, True, True])
    out = toverlay.draw_frame(toverlay.to_rgb(np.zeros((96, 128), np.float32)), uv, z, mask,
                              fps=100.0, reproj_err=0.42)
    want = joverlay.draw_frame(joverlay.to_rgb(np.zeros((96, 128), np.float32)), uv, z, mask,
                               fps=100.0, reproj_err=0.42)
    assert out.tobytes() == want.tobytes()
    assert out[30, 20, 0] > 200 and out[30, 20, 2] < 50
    assert out[60, 100, 2] > 200 and out[60, 100, 0] < 50
    assert (out[96 // 4, 5] == 255).all()
    assert out.shape == (96, 128, 3)


def test_overlay_flow_and_depth_vis():
    f = np.asarray([[10.0, 10.0]])
    t = np.asarray([[20.0, 20.0]])
    out = toverlay.draw_flow(toverlay.to_rgb(np.zeros((64, 64), np.float32)), f, t,
                             np.asarray([True]))
    want = joverlay.draw_flow(joverlay.to_rgb(np.zeros((64, 64), np.float32)), f, t,
                              np.asarray([True]))
    assert out.sum() > 0 and out.tobytes() == want.tobytes()
    d = np.full((32, 32), 5000.0, np.float32)
    d[0, 0] = 50.0   # below min_raw -> invalid -> white
    vis = toverlay.visualize_depth(d)
    assert vis.tobytes() == joverlay.visualize_depth(d).tobytes()
    assert vis.shape == (32, 32, 3)
    assert (vis[0, 0] == 255).all()
    assert not (vis[16, 16] == 255).all()


def test_overlay_loop_match_byte_equal():
    rng = np.random.default_rng(1)
    img_i, img_j = (rng.uniform(0, 255, (48, 64)).astype(np.float32) for _ in range(2))
    uv_i = rng.uniform(0, 60, (12, 2))
    uv_j = rng.uniform(0, 60, (12, 2))
    match_j = rng.integers(0, 12, 12)
    good = rng.uniform(size=12) > 0.4
    out = toverlay.draw_loop_match(img_i, img_j, uv_i, uv_j, match_j, good)
    want = joverlay.draw_loop_match(img_i, img_j, uv_i, uv_j, match_j, good)
    assert out.shape == (48, 128, 3) and out.tobytes() == want.tobytes()
