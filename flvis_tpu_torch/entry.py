"""Entry points of the port (the counterpart of the JAX package's
`__graft_entry__.py`).

entry()               → (fn, example_args): one frontend tracking step
                        (pyramids, LK, RANSAC, motion BA, redetection,
                        stereo depth, keyframe logic) at the small
                        configuration's shapes, on the card by default.
dryrun_multichip(n)   → spawns n ranks (parallel/multihost.spawn) and runs
                        on them what the reference's dry run runs on an
                        n-device mesh: the sequence-sharded tracking step,
                        the system and VIO chunks, MultiSeqSlam over the
                        mesh with a loop node a sequence, the landmark-
                        sharded window BA (`optimize_sharded`), the chunk
                        with it inside (`chunk_fused_sharded`) and the
                        keyframe-sharded BoW scores.  Raises if a rank
                        fails.

    python -m flvis_tpu_torch.entry [--cpu] [N]
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch


def _small_cfg():
    from .config import FrontendConfig

    # Small shapes for quick checks; production runs 752×480 or 1241×376.
    return FrontendConfig(width=256, height=192, num_slots=64, pyramid_levels=3, per_cell=4,
                          min_distance=10.0, margin=12, lk_radius=7, lk_iters=6,
                          ransac_hypotheses=32)


def _camera(cfg, device):
    from .geometry import camera

    return camera.make(200.0, 200.0, cfg.width / 2, cfg.height / 2, baseline=0.12,
                       width=cfg.width, height=cfg.height, device=device)


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) runs one track_frame."""
    from .frontend import tracker

    cfg = _small_cfg()
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    img0 = torch.as_tensor(rng.uniform(0, 255, (cfg.height, cfg.width)).astype(np.float32),
                           device=dev)
    img1 = torch.as_tensor(rng.uniform(0, 255, (cfg.height, cfg.width)).astype(np.float32),
                           device=dev)
    fn = functools.partial(tracker.track_frame, cfg,
                           generator=torch.Generator(device=dev).manual_seed(0))
    return fn, (_camera(cfg, dev), tracker.init_state(cfg, device=dev), img0, img1)


def _dryrun_rank(device_type: str) -> dict:
    """What dryrun_multichip runs on each rank; returns its readings."""
    from .backend import window_ba
    from .config import BackendConfig, LoopConfig, SystemConfig, VioConfig
    from .frontend import tracker
    from .geometry import se3, so3
    from .parallel import dist_ba, dist_loop, mesh as mesh_m, multiseq
    from .parallel.multiseq_loop import MultiSeqSlam

    cfg = _small_cfg()
    mesh = multiseq.make_mesh("cpu" if device_type == "cpu" else None)
    dev, n = mesh.device, mesh.size
    S = n                                       # one sequence a rank
    rng = np.random.default_rng(0)
    cam = _camera(cfg, dev)
    gens = [torch.Generator(device=dev).manual_seed(0)]
    out = {"rank": mesh.rank, "device": str(dev)}

    def images(*shape):
        return multiseq.shard_batch(mesh, rng.uniform(0, 255, shape).astype(np.float32))

    # The sequence-sharded tracking step.
    imgs0, imgs1 = images(S, cfg.height, cfg.width), images(S, cfg.height, cfg.width)
    _, outs = multiseq.track_frame_batch(cfg, [cam], multiseq.init_states(cfg, S, mesh),
                                         imgs0, imgs1, gens)
    out["track_status"] = outs.status.cpu().tolist()

    # The system chunk and the VIO chunk (ba_every 2) on the rank's block.  The
    # schur kernel stays on: MultiSeqSlam below captures its step on the card,
    # and the plain step's solve reads the host.
    bcfg = BackendConfig(window_size=4, max_landmarks=64, min_views=2, iters1=3, iters2=2)
    Tn = 2
    i0, i1 = images(S, Tn, cfg.height, cfg.width), images(S, Tn, cfg.height, cfg.width)
    fe, ba, corr = multiseq.init_system_states(cfg, bcfg, S, mesh)
    *_, sys_outs, sys_costs = multiseq.system_chunk_batch(cfg, bcfg, [cam], fe, ba, corr, i0,
                                                          i1, gens)
    out["system_status"] = sys_outs.status.cpu().tolist()
    vcfg, P = VioConfig(), 4
    ts = torch.arange(1, Tn + 1, dtype=torch.float32, device=dev)[None] * 0.05
    acc = torch.tensor([0.0, 0.0, 9.81], device=dev).expand(1, Tn, P, 3).contiguous()
    gyro = torch.zeros((1, Tn, P, 3), device=dev)
    imu_t = (torch.arange(Tn, dtype=torch.float32, device=dev)[:, None] * 0.05
             + torch.arange(1, P + 1, dtype=torch.float32, device=dev)[None] * 0.0125)[None]
    imu_valid = torch.ones((1, Tn, P), dtype=torch.bool, device=dev)
    fe, ba, corr, vio = multiseq.init_system_states(cfg, bcfg, S, mesh, vcfg=vcfg)
    *_, vio_outs, _ = multiseq.system_chunk_batch_vio(
        cfg, bcfg, vcfg, [cam], [se3.identity(device=dev)], fe, ba, vio, corr, i0, i1,
        ts, acc, gyro, imu_t, imu_valid, [torch.Generator(device=dev).manual_seed(0)],
        ba_every=2)
    out["vio_status"] = vio_outs.status.cpu().tolist()

    # MultiSeqSlam over the mesh, a loop node a sequence.
    sys_cfg = SystemConfig(frontend=cfg, backend=bcfg, loop=LoopConfig(
        max_keyframes=16, num_orb_features=64, vocab_words=64, kf_start=0, kf_dist=1,
        kf_max_dist=4, nkf_closest=1))
    ms = MultiSeqSlam(sys_cfg, cam, num_seqs=S, use_loop=True, mesh=mesh)
    ms.process_chunk(rng.uniform(0, 255, (S, Tn, cfg.height, cfg.width)).astype(np.float32),
                     rng.uniform(0, 255, (S, Tn, cfg.height, cfg.width)).astype(np.float32))
    ms.flush()
    out["multiseq_frames"] = len(ms.trajectories[0])
    out["multiseq_centers"] = ms.trajectory_cam_centers(S - 1).shape

    # The landmark-sharded window BA.
    bcfg_lm = BackendConfig(window_size=4, max_landmarks=16 * n, iters1=3, iters2=2)
    L = bcfg_lm.max_landmarks
    pts = torch.as_tensor(rng.uniform([-2, -2, 4], [2, 2, 10], (L, 3)).astype(np.float32),
                          device=dev)
    st = window_ba.empty(bcfg_lm, device=dev)
    for i in range(bcfg_lm.window_size):
        T = se3.SE3(so3.identity((), device=dev), torch.tensor([0.1 * i, 0.0, 0.0], device=dev))
        pc = se3.transform_points(T, pts)
        uv = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                          cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
        ur = uv[:, 0] - cam.fx * cam.baseline / pc[:, 2]
        pkt = window_ba.KeyframePacket(
            frame_id=torch.tensor(i, dtype=torch.int32, device=dev), q=T.q, t=T.t,
            lm_id=torch.arange(100, 100 + L, dtype=torch.int32, device=dev), lm_uv=uv,
            lm_ur=ur, lm_ur_mask=torch.ones(L, dtype=torch.bool, device=dev), lm_pw=pts,
            lm_mask=torch.ones(L, dtype=torch.bool, device=dev))
        st = window_ba.add_keyframe(bcfg_lm, st, pkt)
    lm_mesh = dist_ba.make_lm_mesh(dev)
    _, _, cost = dist_ba.optimize_sharded(bcfg_lm, lm_mesh, cam,
                                          dist_ba.shard_window_state(lm_mesh, st))
    out["sharded_ba_cost"] = float(cost)

    # The chunk with the sharded window BA inside.
    bcfg_ch = BackendConfig(window_size=4, max_landmarks=16 * n, min_views=2, iters1=3,
                            iters2=2, pallas_schur=False)
    ch = [torch.as_tensor(rng.uniform(0, 255, (2, cfg.height, cfg.width)).astype(np.float32),
                          device=dev) for _ in range(2)]
    _, _, _, (ch_outs, _) = dist_ba.chunk_fused_sharded(
        cfg, bcfg_ch, lm_mesh, cam, tracker.init_state(cfg, device=dev),
        dist_ba.shard_window_state(lm_mesh, window_ba.empty(bcfg_ch, device=dev)),
        dist_ba.shard_correction(lm_mesh, window_ba.null_correction(bcfg_ch, device=dev)),
        ch[0], ch[1], generator=torch.Generator(device=dev).manual_seed(0))
    out["chunk_status"] = ch_outs.status.cpu().tolist()

    # The keyframe-sharded BoW database.
    K, V = 16 * n, 64
    db = torch.as_tensor(rng.uniform(0, 1, (K, V)).astype(np.float32), device=dev)
    db = db / db.abs().sum(1, keepdim=True)
    kf_mesh = dist_loop.make_kf_mesh(dev)
    db_l, valid_l = dist_loop.shard_db(kf_mesh, db, torch.ones(K, dtype=torch.bool, device=dev))
    scores = dist_loop.score_database_sharded(kf_mesh, db[3], db_l, valid_l)
    v, i = dist_loop.best_candidate_sharded(
        kf_mesh, db[3], db_l, valid_l,
        dist_loop.shard_rows(kf_mesh, torch.arange(K, device=dev) < K // 2))
    if scores.shape != (K,):
        raise AssertionError(f"sharded scores of shape {tuple(scores.shape)}, not ({K},)")
    out["best"] = (float(v), int(i))
    mesh_m.barrier(mesh)
    return out


def dryrun_multichip(n_devices: int, device="cuda", threads: int | None = None) -> list:
    """Spawn n_devices ranks (on the card(s), or device="cpu"; threads: the
    ranks' CPU threads) and run the multi-device paths on them; returns each
    rank's readings.  Raises if a rank fails."""
    from .parallel import multihost

    kind = torch.device(device).type
    results = multihost.spawn(_dryrun_rank, n_devices, (kind,), device_type=kind,
                              threads=threads)
    for r in results:
        print(f"dryrun_multichip rank {r['rank']} on {r['device']}: tracking "
              f"{r['track_status']}, system {r['system_status']}, VIO {r['vio_status']}, "
              f"MultiSeqSlam {r['multiseq_frames']} frames, sharded BA cost "
              f"{r['sharded_ba_cost']:.4f}, chunk {r['chunk_status']}, best {r['best']}",
              flush=True)
    return results


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = "cpu" if "--cpu" in argv else "cuda"
    n = int(next((a for a in argv if a.isdigit()), 2))
    fn, args = entry(dev)
    fn(*args)
    print("entry OK")
    dryrun_multichip(n, dev)
