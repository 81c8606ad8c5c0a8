"""KITTI-length composition through the port's loop node (the scenario of
tests/test_longrun.py): 1,100 keyframes through image ingest, the in-run
vocabulary with its doubling refresh schedule, capacity `_grow` doubling
(128 → 2048), the candidate gate, geometric verification, the banded
(> 256-node) PGO and the post-window rebase, composed.  The JAX test's
assertions, without its XLA compile count (the port compiles nothing)."""

import numpy as np
import pytest
import torch

from flvis_tpu_torch.config import LoopConfig
from flvis_tpu_torch.geometry import camera
from flvis_tpu_torch.io.synthetic import PlanarScene, SceneConfig
from flvis_tpu_torch.loop import loop_closing

torch.set_num_threads(1)


@pytest.mark.slow
def test_longrun_1100_keyframes_grow_refresh_banded_pgo_rebase():
    n_kf, leg, step, drift_per_kf = 1100, 200, 0.02, 2e-3
    scfg = SceneConfig(width=160, height=120, fx=160.0, fy=160.0, cx=80.0, cy=60.0,
                       baseline=0.2)
    scene = PlanarScene(scfg, plane_depth=4.0, seed=7)
    cam = camera.make(scfg.fx, scfg.fy, scfg.cx, scfg.cy, scfg.baseline, width=scfg.width,
                      height=scfg.height, device="cpu")
    cfg = LoopConfig(max_keyframes=128, num_orb_features=64, vocab_words=128,
                     vocab_refresh_at=64, kf_start=60, kf_dist=50, search_window=5000,
                     kf_max_dist=50, nkf_closest=2, min_pts=12, min_score=0.03,
                     ratio_ransac=0.3, ransac_hypotheses=64, pgo_iters=100)
    lc = loop_closing.LoopCloser(cfg, cam, device="cpu")

    def x_of(k):
        phase = k % (2 * leg)
        return step * (phase if phase <= leg else 2 * leg - phase)

    keys = [round(x_of(k) / step) for k in range(n_kf)]
    renders = {key: scene.render(np.eye(3), np.asarray([-key * step, 0.0, 0.0]))
               for key in sorted(set(keys))}
    gt_t = np.asarray([[-x_of(k), 0.0, 0.0] for k in range(n_kf)], np.float32)
    odo_t = gt_t + np.asarray([[0.0, -drift_per_kf * k, 0.0] for k in range(n_kf)], np.float32)
    for c0 in range(0, n_kf, 32):
        ks_range = range(c0, min(c0 + 32, n_kf))
        il = np.stack([renders[keys[k]][0] for k in ks_range])
        ir = np.stack([renders[keys[k]][1] for k in ks_range])
        q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (len(il), 1))
        ks = lc.add_keyframes_batch(il, ir, list(range(len(il))), q, odo_t[list(ks_range)],
                                    list(ks_range))
        if lc.detect_loops_batch(ks):
            lc.optimize_graph()

    assert lc.count == n_kf
    assert lc.bow_db.shape[0] >= 2048
    assert lc._next_vocab_refresh > 1024 and lc._in_run_vocab
    assert len(lc.closures) >= 3
    i0 = min(c.kf_i for c in lc.closures)
    j1 = max(c.kf_j for c in lc.closures)
    assert j1 - i0 + 1 > loop_closing._BANDED_THRESHOLD, (i0, j1)
    assert max(c.kf_j - c.kf_i for c in lc.closures) >= 2 * leg - 60
    sel = np.arange(i0, n_kf)
    c_gt, c_odo = -gt_t[sel], -odo_t[sel]
    c_node = lc.kf_t[i0:n_kf].numpy()
    err_odo = np.linalg.norm(c_odo - c_gt, axis=-1).mean()
    err_node = np.linalg.norm(c_node - c_gt, axis=-1).mean()
    assert err_node < 0.2 * err_odo, (err_node, err_odo)
    assert float(torch.linalg.vector_norm(lc.T_map_odom.t)) > 0.5
