"""Loop closing: place recognition, geometric verification, pose-graph
optimisation and the map→odom drift (port of flvis_tpu/loop/loop_closing.py).

Per keyframe: ORB detect + compute (fastblur kernel) and keypoint depth
from the half-res plane sweep (sweep kernel) — or, in depth mode, from the
aligned depth image — are written into the device-resident keyframe
store; once a vocabulary exists, the keyframe's tf-idf BoW row (bowassign
kernel) goes into the database.  The candidate
gate scores a query against the database (BoW similarity in the temporal
window, adaptive minimum score, neighbour consistency), verification runs
on the survivor (mutual-ratio ORB matching through the hamming kernel, PnP
RANSAC, translation/rotation accept gates) and `optimize_graph` runs the
windowed pose graph — dense up to 256 padded nodes, banded past that, as
the reference switches — and re-bases the keyframes after the window onto
the new drift.

Two ways in, with the reference's semantics:
  - stepwise: `add_keyframe` + `detect_loop`, resolved at once (the
    reference's process_frame path);
  - chunked: `add_keyframes_batch` ingests a chunk's keyframes and makes
    their BoW rows in one transform_rows, `gate_candidates` computes the
    gate rows of the chunk's queries, and the caller resolves them one
    chunk later (`dispatch_verify` → verification) and the verification
    statistics one chunk after that (`resolve_verify`), each fetched with
    the chunk's packed outputs (pipeline/runner.LoopStage).
    The gate rows and statistics are computed when they are dispatched, on
    the database and poses of that moment, as the reference's dispatched
    programs see them.

Debug surface (dump_dir): a similarity matrix every 10 keyframes, the
pose graph before and after each PGO, and one match image per accepted
closure, as the reference writes them; only then does the loop node keep
host copies of the keyframes' left images.  pgo_device: the PGO solve on
another device (a caller's explicit choice), the poses coming back to the
pose tables' device.

mesh: the BoW database split by rows over the ranks of a `kf` mesh axis
(parallel/dist_loop; the reference's LoopCloser(mesh=)).  Every rank runs
the same loop node — the same store, ingest, verification and PGO — and
keeps only its block of database rows: a row is written by its owner, a
query's scores come back all-gathered, and the candidate gate runs
synchronously per query (`_detect_sharded`, verification a bucket of one),
so the gate handle is ("sync", ks) and dispatch_verify returns ("done",
closures) at once; the caller then runs optimize_graph.  The ranks' scores,
closures and loop poses are the same bits.  device: the loop node's own
device (SlamSystem(loop_device=) puts it beside the frontend's).

Differences from the reference, by design:
  - Ingest without shape padding: the reference pads its ingest to blocks
    of {32, 8, 4} keyframes to keep XLA shapes stable, then drops the
    padded rows; the port ingests and transforms only the real rows, with
    the same results.  Verification runs in buckets of up to 8 real pairs:
    the reference pads the last bucket with its last pair to its compiled
    shape and drops those rows; the port, eager outside the captured frame
    step, verifies only the real pairs.
  - Random draws: the verification's PnP RANSAC scores (the reference's
    jax.random.PRNGKey(i·7919 + j), loop_closing.py:977,1062) come from
    `_verify_scores`, a torch.Generator seeded with i·7919 + j; the
    vocabulary's initial centroids come from `bow.train`'s generator.  The
    parity tests hand in the reference's draws at these two points.
  - The database row writes are in-place tensor writes (the reference
    donates buffers to the same end).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import LoopConfig
from ..geometry import camera as cam_m, se3 as se3m, so3
from ..geometry.camera import StereoCamera
from ..geometry.se3 import SE3
from ..ops import image as imops, orb, pnp, stereo
from ..ops.kernels import hamming
from ..parallel import dist_loop, mesh as mesh_m
from ..utils import profiling
from ..utils.tree import tree_map
from . import bow, pose_graph

# Loop windows up to this many (padded) nodes take the dense PGO solve, and
# wider ones the banded solver, as the reference switches (loop_closing.py:1108).
_BANDED_THRESHOLD = 256
# Candidate pairs verified together (the reference's 8-wide
# _verify_device_batch buckets, loop_closing.py:964-985).
VERIFY_BUCKET = 8


def _ingest(img_l, img_r, cam: StereoCamera, num_features: int, depth_mode: bool = False):
    """ORB features of the left image plus their depth: from the stereo
    sweep, or in depth mode from img_r as an aligned depth image (raw units,
    / cam.depth_factor).  Returns (uv, desc, kp_valid, p_c, pc_valid)."""
    img_l = img_l.to(torch.float32)
    uv, desc, kp_valid, _ = orb.detect_and_compute(img_l, num_features=num_features)
    if depth_mode:
        z = imops.bilinear_sample(img_r, uv) / cam.depth_factor
        d_ok = (z > 0.1) & (z < 100.0)
    else:
        img_r = img_r.to(torch.float32)
        disp_map, dv = stereo.disparity_sweep(img_l, img_r)
        disp, d_ok = stereo.keypoint_disparity(disp_map, dv, uv)
        z = cam.fx * cam.baseline / torch.clamp(disp, min=1e-3)
        d_ok = d_ok & (z > 0.1) & (z < 100.0)
    return uv, desc, kp_valid, cam_m.backproject(cam, uv, z), d_ok & kp_valid


def _host_image(img) -> np.ndarray:
    """A keyframe image (host array or tensor) as a host numpy array."""
    return img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)


def _gate_row(db, valid_rows, k: int, lo: int, hi: int, nb_dist: int):
    """Candidate gate of query k over the database (isLoopCandidate): the
    best candidate in [lo, hi), the adaptive minimum score from the recent
    neighbours [hi, k), and the neighbour-consistency count.  Returns
    [cand, best, n_close, lc_min] (float32, 4)."""
    idxs = torch.arange(db.shape[0], device=db.device)
    sims = bow.score_database(db[k], db, valid_rows)
    in_win = (idxs >= lo) & (idxs < hi)
    sims_w = torch.where(in_win, sims, -torch.inf)
    cand = torch.argmax(sims_w)
    with profiling.host_sync("loop.gate_index"):        # a 0-d index tensor is read as an int
        best = sims_w[cand]
    recent = (idxs >= hi) & (idxs < k) & (sims > 0.001)
    lc_min = torch.clamp(torch.min(torch.where(recent, sims, 1.0)), max=0.4)
    nb = in_win & (torch.abs(idxs - cand) <= nb_dist) & (idxs != cand)
    close = torch.sum(nb & (sims >= 0.8 * lc_min))
    return torch.stack([cand.to(torch.float32), best, close.to(torch.float32), lc_min])


def _gate_rows(db, valid_rows, ks, los, his, nb_dist: int):
    """_gate_row for M queries → (M, 4) float32."""
    return torch.stack([_gate_row(db, valid_rows, k, lo, hi, nb_dist)
                        for k, lo, hi in zip(ks, los, his)])


def _gate_decision(row, lo: int, hi: int, cfg: LoopConfig):
    """Host accept decision over a gate row: the candidate index or None."""
    if hi <= lo:
        return None
    cand, best, close, lc_min = int(row[0]), float(row[1]), int(row[2]), float(row[3])
    if best < max(cfg.min_score, lc_min):
        return None
    if close < cfg.nkf_closest:
        return None
    return cand


def _verify_scores(i: int, j: int, num_hypotheses: int, n: int, device):
    """Uniform (num_hypotheses, n) RANSAC scores of the verification of
    candidate pair (i, j)."""
    g = torch.Generator(device=device).manual_seed(i * 7919 + j)
    return torch.rand((num_hypotheses, n), generator=g, device=device)


@dataclasses.dataclass
class LoopClosure:
    """Record of an accepted loop closure."""

    kf_i: int              # older keyframe index
    kf_j: int              # newer keyframe index
    num_inliers: int
    T_ij: SE3              # measured relative pose i → j (CPU tensors)


class _PoseView:
    """Indexable view of a (K, 4)/(K, 3) pose table as SE3 rows."""

    def __init__(self, owner, q_name: str, t_name: str):
        self._owner, self._q, self._t = owner, q_name, t_name

    def __getitem__(self, i) -> SE3:
        return SE3(getattr(self._owner, self._q)[i], getattr(self._owner, self._t)[i])

    def __len__(self) -> int:
        return self._owner.count


class LoopCloser:
    """Keyframe database + loop detection + pose-graph correction, on one
    device (default "cuda"; with `mesh`, the mesh's).  With depth_mode, the
    second image of every keyframe is an aligned depth image (RGB-D), not
    the right stereo image.  mesh: a parallel/mesh.Mesh on the `kf` axis,
    the database split over its ranks (module note); cfg.max_keyframes must
    divide by its size."""

    def __init__(self, cfg: LoopConfig, cam: StereoCamera,
                 vocab: Optional[bow.Vocabulary] = None, device="cuda",
                 depth_mode: bool = False, pgo_device=None, dump_dir: Optional[str] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        # The camera's intrinsics on the loop node's device.
        cam = tree_map(lambda a: a.to(device), cam)
        self.cam = cam
        self.depth_mode = depth_mode
        # The verification's PnP inlier threshold, 3 px in normalised units,
        # read from the camera once (not on every bucket).
        self._pnp_thr = 3.0 / float(cam.fx)
        self.vocab = vocab
        self.device = torch.device(device)
        dev = self.device
        # The PGO solve's device (None: the loop node's own).
        self.pgo_device = torch.device(pgo_device) if pgo_device is not None else None
        # Debug-dump directory: similarity-matrix txt every 10 keyframes, the
        # pose graph before/after each PGO run and a match PNG per accepted
        # closure (the reference writes these to hard-coded home paths,
        # vo_loopclosing.cpp:439-452,689-722,879,887).
        self.dump_dir = dump_dir
        # Host copies of the keyframes' left images, kept only for the match
        # images: without dump_dir nothing image-sized is read to the host.
        self._kf_imgs: Optional[list] = [] if dump_dir is not None else None
        K, F, V = cfg.max_keyframes, cfg.num_orb_features, cfg.vocab_words
        # With a mesh, only the rank's block of rows (dist_loop.shard_db).
        self.bow_db = torch.zeros((K // (mesh.size if mesh is not None else 1), V), device=dev)
        if mesh is not None and K % mesh.size:
            raise ValueError(f"max_keyframes={K} does not split over {mesh.size} ranks")
        self.kf_uv = torch.zeros((K, F, 2), device=dev)
        self.kf_desc = torch.zeros((K, F, 8), dtype=torch.int32, device=dev)
        self.kf_kp_valid = torch.zeros((K, F), dtype=torch.bool, device=dev)
        self.kf_pc = torch.zeros((K, F, 3), device=dev)        # keypoint 3D, camera frame
        self.kf_pc_valid = torch.zeros((K, F), dtype=torch.bool, device=dev)
        self.kf_frame_id = np.full(K, -1, np.int64)
        # Odometry poses and PGO-corrected node poses, both as T_w_c.
        self.kf_q_odom = so3.identity((K,), device=dev)
        self.kf_t_odom = torch.zeros((K, 3), device=dev)
        self.kf_q = so3.identity((K,), device=dev)
        self.kf_t = torch.zeros((K, 3), device=dev)
        self.count = 0
        self.closures: list[LoopClosure] = []
        self.T_map_odom: SE3 = se3m.identity(device=dev)   # drift: corrected ∘ odom⁻¹
        # PGO throttle (vo_loopclosing.cpp:160,487-495): re-optimise only once
        # the newest loop is > 2 % of the keyframe count past the last run.
        self._last_pgo_id = -5000
        self._desc_buffer: list = []    # (desc, valid) per keyframe until a vocabulary
        # In-run vocabularies are retrained each time the run doubles past the
        # last training point (vocab_refresh_at, 2x, 4x, ...).
        self._in_run_vocab = False
        self._next_vocab_refresh = cfg.vocab_refresh_at

    @property
    def kf_T_wc(self) -> _PoseView:
        return _PoseView(self, "kf_q", "kf_t")

    @property
    def kf_T_wc_odom(self) -> _PoseView:
        return _PoseView(self, "kf_q_odom", "kf_t_odom")

    # ------------------------------------------------------------------ add
    def _as_device(self, img):
        return img.to(self.device) if torch.is_tensor(img) else \
            torch.as_tensor(np.asarray(img), device=self.device)

    def _set_pose_rows(self, r0: int, T_c_w_odom: SE3) -> None:
        """Rows r0.. of the pose tables from (M,)-batched T_c_w odometry
        poses: the odometry pose as T_w_c, and the node pose at its
        drift-corrected value T_map_odom ∘ T_w_c."""
        dev = self.device
        T_wc = se3m.inverse(SE3(T_c_w_odom.q.to(dev), T_c_w_odom.t.to(dev)))
        T_node = se3m.compose(self.T_map_odom, T_wc)
        m = T_wc.q.shape[0]
        self.kf_q_odom[r0:r0 + m], self.kf_t_odom[r0:r0 + m] = T_wc.q, T_wc.t
        self.kf_q[r0:r0 + m], self.kf_t[r0:r0 + m] = T_node.q, T_node.t

    def _ingest_row(self, k: int, img_l, img_r):
        """ORB + depth of one keyframe into store row k; returns (desc,
        kp_valid)."""
        uv, desc, kp_valid, p_c, pc_valid = _ingest(img_l, img_r, self.cam,
                                                    self.cfg.num_orb_features, self.depth_mode)
        self.kf_uv[k] = uv
        self.kf_desc[k] = desc
        self.kf_kp_valid[k] = kp_valid
        self.kf_pc[k] = p_c
        self.kf_pc_valid[k] = pc_valid
        return desc, kp_valid

    def add_keyframe(self, img_l, img_r, T_c_w_odom: SE3, frame_id: int) -> int:
        """Ingest one keyframe (host arrays or tensors): features, depth,
        store rows, poses and, once a vocabulary exists, its BoW row.
        Returns its keyframe index."""
        k = self.count
        if k >= self.capacity:
            self._grow()
        desc, kp_valid = self._ingest_row(k, self._as_device(img_l), self._as_device(img_r))
        self.kf_frame_id[k] = frame_id
        self._set_pose_rows(k, SE3(T_c_w_odom.q[None], T_c_w_odom.t[None]))
        if self.vocab is None:
            self._desc_buffer.append((desc, kp_valid))
            if k + 1 >= 8:
                self._train_vocab()
        if self.vocab is not None:
            row = bow.transform(self.vocab, desc, kp_valid)
            if self.mesh is not None:
                dist_loop.set_row(self.mesh, self.bow_db, k, row)
            else:
                self.bow_db[k] = row
        self.count += 1
        self._maybe_refresh_vocab()
        if self._kf_imgs is not None:
            self._kf_imgs.append(_host_image(img_l))
        if self.dump_dir is not None and self.count % 10 == 0:
            self.dump_sim_matrix(f"{self.dump_dir}/sim_matrix_{self.count:05d}.txt")
        return k

    def add_keyframes_batch(self, imgs_l, imgs_r, sel, q, t, frame_ids) -> list:
        """Ingest a chunk's keyframes (the reference's chunked-replay path).

        imgs_l/imgs_r: (T, H, W) stacks of the chunk's frames (host arrays
        or tensors); sel: chunk indices of its keyframes; q/t: (M, 4)/(M, 3)
        host arrays, the keyframes' T_c_w odometry poses; frame_ids: their
        global frame ids.  Each keyframe is ingested into its store row, the
        pose rows are written together and, once a vocabulary exists, the
        BoW rows are made by one transform_rows.  Without a vocabulary the
        descriptors are buffered, and the vocabulary is trained after the
        whole chunk once ≥ 8 keyframes exist (back-filling every row).
        Returns the assigned keyframe indices."""
        M = len(sel)
        if M == 0:
            return []
        while self.count + M > self.capacity:
            self._grow()
        imgs_l, imgs_r = self._as_device(imgs_l), self._as_device(imgs_r)
        c0 = self.count
        for i, f in enumerate(sel):
            self._ingest_row(c0 + i, imgs_l[int(f)], imgs_r[int(f)])
        with profiling.host_sync("loop.pose_rows", 2):
            q_t = (torch.as_tensor(np.asarray(q, np.float32), device=self.device),
                   torch.as_tensor(np.asarray(t, np.float32), device=self.device))
        self._set_pose_rows(c0, SE3(*q_t))
        if self.vocab is None:
            self._desc_buffer.append((self.kf_desc[c0:c0 + M], self.kf_kp_valid[c0:c0 + M]))
        else:
            self._set_db_rows(c0, c0 + M)
        self.kf_frame_id[c0:c0 + M] = np.asarray(frame_ids, np.int64)
        self.count += M
        if self.vocab is None and self.count >= 8:
            self._train_vocab()       # back-fills every row, this chunk's too
        self._maybe_refresh_vocab()
        if self._kf_imgs is not None:
            self._kf_imgs.extend(_host_image(imgs_l[[int(f) for f in sel]]))
        if self.dump_dir is not None and c0 // 10 != self.count // 10:
            self.dump_sim_matrix(f"{self.dump_dir}/sim_matrix_{self.count:05d}.txt")
        return list(range(c0, c0 + M))

    # -------------------------------------------------------------- debug IO
    def sim_matrix(self) -> np.ndarray:
        """Pairwise BoW similarity over the stored keyframes (count,
        count), each row bow.score_database's, computed in row blocks on the
        loop node's device."""
        n = self.count
        if self.vocab is None or n == 0:
            return np.zeros((n, n), np.float32)
        db = self._whole_db()[:n]
        rows = max(1, (1 << 26) // (n * db.shape[1]))     # ≤ 256 MiB of differences a block
        S = torch.cat([1.0 - 0.5 * torch.sum(torch.abs(db[None, :, :] - db[r:r + rows, None, :]),
                                             dim=2)
                       for r in range(0, n, rows)])
        return S.cpu().numpy()

    def dump_sim_matrix(self, path: str) -> None:
        np.savetxt(path, self.sim_matrix(), fmt="%.6f")

    def _dump_graph(self, tag: str) -> None:
        """Pose-graph snapshot (the reference's optimizer.save of
        before.g2o/after.g2o) as an .npz of node poses + edge list."""
        n = self.count
        np.savez(f"{self.dump_dir}/pose_graph_{tag}.npz",
                 node_q=self.kf_q[:n].cpu().numpy(), node_t=self.kf_t[:n].cpu().numpy(),
                 loops=np.asarray([[c.kf_i, c.kf_j, c.num_inliers] for c in self.closures],
                                  np.int64))

    def _match_pairs(self, i: int, j: int):
        """Mutual-ratio matches between stored keyframes i and j — the
        debug companion of the verification, a bucket of one for the
        hamming kernel's match mode.  Returns (match_j, good), (F,) each."""
        match_j, good = hamming.mutual_ratio_match(
            self.kf_desc[i][None], self.kf_desc[j][None],
            (self.kf_kp_valid[i] & self.kf_pc_valid[i])[None], self.kf_kp_valid[j][None],
            ratio=self.cfg.ratio_max)[:2]
        return match_j[0], good[0]

    def _save_match_image(self, i: int, j: int) -> None:
        """The accepted closure (i, j)'s side-by-side match image (the
        reference's debugging surface for bad loops, vo_loopclosing.cpp:
        689-722), when both keyframes' images are held."""
        imgs = self._kf_imgs
        if imgs is None or len(imgs) <= max(i, j) or imgs[i] is None or imgs[j] is None:
            return
        from ..viz import overlay

        mj, good = self._match_pairs(i, j)
        img = overlay.draw_loop_match(imgs[i], imgs[j], self.kf_uv[i].cpu().numpy(),
                                      self.kf_uv[j].cpu().numpy(), mj.cpu().numpy(),
                                      good.cpu().numpy())
        overlay.save_png(f"{self.dump_dir}/loop_match_{i:05d}_{j:05d}.png", img)

    @property
    def capacity(self) -> int:
        """Keyframe rows of every table (the database's, over all ranks)."""
        return self.kf_q.shape[0]

    def _whole_db(self):
        """The (capacity, V) database: with a mesh, all-gathered from the
        ranks' blocks (a collective)."""
        if self.mesh is None:
            return self.bow_db
        return mesh_m.all_gather(self.mesh, self.bow_db)

    def _grow(self) -> None:
        """Double the keyframe capacity of every table (with a mesh, the
        database gathered, doubled and split again: a rank's block moves)."""
        K = self.capacity

        def zpad(a):
            return torch.cat([a, torch.zeros_like(a)])

        def qpad(a):
            return torch.cat([a, so3.identity((K,), a.dtype, a.device)])

        db = zpad(self._whole_db())
        self.bow_db = db if self.mesh is None else dist_loop.shard_rows(self.mesh, db)
        self.kf_uv, self.kf_desc = zpad(self.kf_uv), zpad(self.kf_desc)
        self.kf_kp_valid, self.kf_pc = zpad(self.kf_kp_valid), zpad(self.kf_pc)
        self.kf_pc_valid = zpad(self.kf_pc_valid)
        self.kf_q_odom, self.kf_t_odom = qpad(self.kf_q_odom), zpad(self.kf_t_odom)
        self.kf_q, self.kf_t = qpad(self.kf_q), zpad(self.kf_t)
        self.kf_frame_id = np.concatenate([self.kf_frame_id, np.full(K, -1, np.int64)])

    def _set_db_rows(self, r0: int, r1: int) -> None:
        """BoW rows [r0, r1) from their stored descriptors, in one
        transform_rows (the reference's _bow_rows).  With a mesh each rank
        makes and writes only the rows it owns (the reference's per-row
        sharded set_row)."""
        o = 0
        if self.mesh is not None:
            own = dist_loop.row_range(self.mesh, self.bow_db)
            r0, r1, o = max(r0, own.start), min(r1, own.stop), own.start
            if r0 >= r1:
                return
        self.bow_db[r0 - o:r1 - o] = bow.transform_rows(self.vocab, self.kf_desc[r0:r1],
                                                        self.kf_kp_valid[r0:r1])

    def _train_vocab(self):
        """Train the vocabulary from the buffered keyframes once they hold at
        least vocab_words/2 descriptors, then back-fill every stored row."""
        with profiling.span("vocab.train", keyframes=self.count):
            # Each boolean selection waits for the device (its size).
            with profiling.host_sync("loop.vocab_select", len(self._desc_buffer)):
                all_desc = torch.cat([d[v] for d, v in self._desc_buffer])
            if all_desc.shape[0] < self.cfg.vocab_words // 2:
                return
            self.vocab = bow.train(all_desc, torch.ones(all_desc.shape[0], dtype=torch.bool),
                                   num_words=self.cfg.vocab_words, iters=6)
            self._in_run_vocab = True
            self._desc_buffer.clear()
            self._set_db_rows(0, self.count)

    def _maybe_refresh_vocab(self):
        """Retrain the in-run vocabulary on a fixed 8192-descriptor sample
        each time the run doubles past its last training point, then
        back-fill every BoW row."""
        cfg = self.cfg
        if (not self._in_run_vocab or cfg.vocab_refresh_at <= 0
                or self.count < self._next_vocab_refresh):
            return
        n = self.count
        with profiling.span("vocab.refresh", keyframes=n):
            with profiling.host_sync("loop.vocab_select"):
                all_desc = self.kf_desc[:n][self.kf_kp_valid[:n]]
            sel = np.random.default_rng(n).choice(all_desc.shape[0], 8192,
                                                  replace=all_desc.shape[0] < 8192)
            with profiling.host_sync("loop.vocab_sample"):
                sel = torch.as_tensor(sel, device=all_desc.device)
            all_desc = all_desc[sel]
            self.vocab = bow.train(all_desc, torch.ones(8192, dtype=torch.bool),
                                   num_words=cfg.vocab_words, iters=6, seed=1)
            self._set_db_rows(0, n)
            self._next_vocab_refresh = max(self._next_vocab_refresh * 2, n + 1)

    # --------------------------------------------------------------- search
    def detect_loop(self, k: int) -> Optional[LoopClosure]:
        """Candidate gate + geometric verification for keyframe k, resolved
        at once.  Returns the accepted LoopClosure (also appended to
        self.closures) or None."""
        hits = self.detect_loops_batch([k])
        return hits[0] if hits else None

    def detect_loops_batch(self, ks) -> list:
        """Gate and verify a batch of keyframes at once; returns the accepted
        LoopClosures."""
        return self.decide_loops(self.gate_candidates(ks))

    def gate_candidates(self, ks):
        """The candidate gate of queries ks (those ≥ kf_start), computed now
        on the current database and left on the device: a pending handle
        ("rows", ks, los, his, (M, 4) rows) for dispatch_verify, or None."""
        cfg = self.cfg
        ks = [k for k in ks if k >= cfg.kf_start]
        if self.vocab is None or not ks:
            return None
        if self.mesh is not None:
            # The sharded database's per-query gate runs synchronously, in
            # dispatch_verify (_detect_sharded).
            return ("sync", ks)
        his = [k - cfg.kf_dist for k in ks]
        los = [max(0, h - cfg.search_window) for h in his]
        valid_rows = torch.arange(self.bow_db.shape[0], device=self.device) < self.count
        rows = _gate_rows(self.bow_db, valid_rows, ks, los, his, cfg.kf_max_dist)
        return ("rows", ks, los, his, rows)

    def pending_rows(self, pending):
        """The device rows inside a gate_candidates handle, or None."""
        return pending[4] if pending is not None and pending[0] == "rows" else None

    def decide_loops(self, pending, rows_np=None) -> list:
        """Resolve a gate_candidates handle at once: host decisions, then
        verification."""
        return self.resolve_verify(self.dispatch_verify(pending, rows_np))

    def dispatch_verify(self, pending, rows_np=None):
        """Host accept decisions over a gate handle's rows (rows_np: the rows
        already fetched; fetched here otherwise), then the verification of
        every candidate pair, left on the device.  Returns None (nothing to
        verify), ("verify", cands, (n, 11) statistics), or, for a sharded
        database's ("sync", ks), ("done", accepted closures) at once."""
        if pending is None:
            return None
        with profiling.span("loop.verify", pairs=0, buckets=0) as sp:
            if pending[0] == "sync":
                sp.set(pairs=len(pending[1]), buckets=len(pending[1]))
                return ("done", [lc for k in pending[1]
                                 for lc in (self._detect_sharded(k),) if lc is not None])
            _, ks, los, his, rows_dev = pending
            rows = (profiling.host_read(rows_dev, site="loop.gate_rows") if rows_np is None
                    else rows_np)
            cands = [(cand, k) for k, lo, hi, row in zip(ks, los, his, rows)
                     for cand in (_gate_decision(row, lo, hi, self.cfg),) if cand is not None]
            if not cands:
                return None
            # Buckets of up to VERIFY_BUCKET real pairs.  The reference pads
            # the last bucket with its last pair to its compiled shape; the
            # loop node runs eagerly here, outside the captured frame step, so
            # a bucket takes any size and the padding's matcher/EPnP work is
            # left out.
            stats = []
            for b0 in range(0, len(cands), VERIFY_BUCKET):
                bucket = cands[b0:b0 + VERIFY_BUCKET]
                stats.append(self._verify_device_batch([i for i, _ in bucket],
                                                       [j for _, j in bucket]))
            sp.set(pairs=len(cands), buckets=len(stats))
            return ("verify", cands, torch.cat(stats))

    def pending_verify_arrays(self, handle):
        """The device statistics inside a dispatch_verify handle, or None."""
        return handle[2] if handle is not None and handle[0] == "verify" else None

    def resolve_verify(self, handle, stats=None) -> list:
        """The host accept gates over a dispatch_verify handle's statistics
        (stats: already fetched; fetched here otherwise).  Returns the
        accepted LoopClosures (also appended to self.closures)."""
        if handle is None:
            return []
        if handle[0] == "done":
            return handle[1]
        _, cands, stats_dev = handle
        with profiling.span("loop.accept", pairs=len(cands)) as sp:
            if stats is None:
                stats = profiling.host_read(stats_dev, site="loop.verify_stats")
            out = [lc for (i, j), row in zip(cands, stats)
                   for lc in (self._verify_accept(i, j, row),) if lc is not None]
            sp.set(accepted=len(out))
            return out

    def _detect_sharded(self, k: int) -> Optional[LoopClosure]:
        """The candidate gate of query k on the sharded database, resolved at
        once (the reference's _detect_sharded, loop_closing.py:1015-1041):
        the all-gathered scores, the host's gate over them (the adaptive
        minimum score, neighbour consistency), then the verification of the
        surviving pair."""
        cfg = self.cfg
        own = dist_loop.row_range(self.mesh, self.bow_db)
        valid = torch.arange(own.start, own.stop, device=self.device) < self.count
        query = dist_loop.get_row(self.mesh, self.bow_db, k)
        sims = profiling.host_read(dist_loop.score_database_sharded(
            self.mesh, query, self.bow_db, valid)[:self.count], site="loop.sharded_scores")
        hi = k - cfg.kf_dist
        lo = max(0, hi - cfg.search_window)
        if hi <= lo:
            return None
        window = sims[lo:hi]
        cand = int(np.argmax(window)) + lo
        recent = sims[hi:k]
        recent = recent[recent > 0.001]
        lc_min = min(float(recent.min()) if len(recent) else 1.0, 0.4)
        if float(sims[cand]) < max(cfg.min_score, lc_min):
            return None
        idxs = np.arange(lo, hi)
        nb = (np.abs(idxs - cand) <= cfg.kf_max_dist) & (idxs != cand)
        if int(np.sum(window[nb] >= 0.8 * lc_min)) < cfg.nkf_closest:
            return None
        return self._verify(cand, k)

    def _verify(self, i: int, j: int) -> Optional[LoopClosure]:
        """Verification of one candidate pair, resolved at once: a bucket of
        one through _verify_device_batch, then the accept gates."""
        return self._verify_accept(i, j, profiling.host_read(self._verify_device(i, j),
                                                             site="loop.verify_stats"))

    def _verify_device(self, i: int, j: int):
        """Geometric verification of candidate pair (i, j): a bucket of one.
        Returns its (11,) float32 statistics row."""
        return self._verify_device_batch([i], [j])[0]

    def _verify_device_batch(self, iis, jjs):
        """Geometric verification of the candidate pairs (iis[b], jjs[b]) on
        the device, all at once (the reference's 8-wide vmapped
        _verify_device_batch): their rows gathered from the resident store
        (views stacked from the host lists, no host read), mutual-ratio
        matches (the hamming kernel's match mode), PnP RANSAC from keyframe
        i's world points to j's normalised pixels over every pair's
        hypotheses together, and the accept-gate statistics.  Returns (B,
        11) float32 rows [T_ij.q, T_ij.t, n_match, n_inl, |Δt|, |Δlog R|]."""
        cfg, cam = self.cfg, self.cam

        def rows(table, ks):
            return torch.stack([table[k] for k in ks])

        valid_i = rows(self.kf_kp_valid, iis) & rows(self.kf_pc_valid, iis)
        match_j, good = hamming.mutual_ratio_match(
            rows(self.kf_desc, iis), rows(self.kf_desc, jjs), valid_i,
            rows(self.kf_kp_valid, jjs), ratio=cfg.ratio_max)[:2]
        T_wc_i = SE3(rows(self.kf_q, iis), rows(self.kf_t, iis))
        pts_w = se3m.transform_points(SE3(T_wc_i.q[:, None], T_wc_i.t[:, None]),
                                      rows(self.kf_pc, iis))
        uv_j = torch.gather(rows(self.kf_uv, jjs), 1, match_j[..., None].expand(-1, -1, 2))
        xn = torch.stack([(uv_j[..., 0] - cam.cx) / cam.fx, (uv_j[..., 1] - cam.cy) / cam.fy], -1)
        draws = {}
        for p in zip(iis, jjs):
            if p not in draws:
                draws[p] = _verify_scores(*p, cfg.ransac_hypotheses, good.shape[1], self.device)
        scores = torch.stack([draws[p] for p in zip(iis, jjs)])
        T_cj_w, _, n_inl = pnp.pnp_ransac(scores, pts_w, xn, good, threshold_n=self._pnp_thr)
        T_wc_j_meas = se3m.inverse(T_cj_w)
        delta = se3m.compose(se3m.inverse(SE3(rows(self.kf_q, jjs), rows(self.kf_t, jjs))),
                             T_wc_j_meas)
        T_ij = se3m.compose(se3m.inverse(T_wc_i), T_wc_j_meas)
        return torch.cat([T_ij.q, T_ij.t, torch.sum(good, dim=-1, keepdim=True).to(torch.float32),
                          n_inl[:, None].to(torch.float32),
                          torch.linalg.vector_norm(delta.t, dim=-1, keepdim=True),
                          torch.linalg.vector_norm(so3.log(delta.q), dim=-1, keepdim=True)], -1)

    def _verify_accept(self, i: int, j: int, row) -> Optional[LoopClosure]:
        """Host accept gates over one fetched statistics row."""
        cfg = self.cfg
        n_match, n_inl, dt, dr = int(row[7]), int(row[8]), float(row[9]), float(row[10])
        if n_match < cfg.min_pts:
            return None
        if n_inl < cfg.min_pts or n_inl < cfg.ratio_ransac * n_match:
            return None
        if dt > cfg.max_trans or dr > cfg.max_rot:
            return None
        row = torch.as_tensor(np.asarray(row, np.float32))
        lc = LoopClosure(i, j, n_inl, SE3(row[:4], row[4:7]))
        self.closures.append(lc)
        self._save_match_image(i, j)
        return lc

    # ------------------------------------------------------------------ PGO
    def _build_graph(self, i0: int, wn: int, loop_i, loop_j, loop_q, loop_t, loop_valid,
                     n_pad: int, n_succ: int) -> pose_graph.PoseGraph:
        """The PGO problem over the loop window [i0, i0 + wn): nodes from the
        corrected pose table, sequential odometry edges to n_succ successors
        (weight 1/s), then the loop edges (weight 5, window-local)."""
        dev = self.device
        a = torch.arange(n_pad, device=dev)
        rows = torch.clamp(i0 + a, max=self.kf_q_odom.shape[0] - 1)
        Ta = SE3(self.kf_q_odom[rows], self.kf_t_odom[rows])
        ei, ej, eq, et, ev, ew = [], [], [], [], [], []
        for s in range(1, n_succ + 1):
            b = torch.clamp(a + s, max=n_pad - 1)
            rel = se3m.compose(se3m.inverse(Ta), SE3(Ta.q[b], Ta.t[b]))
            ei.append(a)
            ej.append(b)
            eq.append(rel.q)
            et.append(rel.t)
            ev.append(a + s < wn)
            ew.append(torch.full((n_pad,), 1.0 / s, device=dev))
        L = loop_i.shape[0]
        # Five uploads from pageable host memory: each waits for the device.
        with profiling.host_sync("pgo.loop_edges", 5):
            ei.append(torch.as_tensor(loop_i - i0, device=dev))
            ej.append(torch.as_tensor(loop_j - i0, device=dev))
            eq.append(torch.as_tensor(loop_q, device=dev))
            et.append(torch.as_tensor(loop_t, device=dev))
            ev.append(torch.as_tensor(loop_valid, device=dev))
        ew.append(torch.full((L,), 5.0, device=dev))
        return pose_graph.PoseGraph(
            node_q=self.kf_q[rows], node_t=self.kf_t[rows], node_valid=a < wn,
            edge_i=torch.cat(ei), edge_j=torch.cat(ej), edge_q=torch.cat(eq),
            edge_t=torch.cat(et), edge_valid=torch.cat(ev), edge_weight=torch.cat(ew))

    def _apply_pgo(self, g_q, g_t, i0: int, wn: int, n: int) -> None:
        """Write the optimised window back, recompute the drift from the last
        window keyframe and re-base every keyframe after the window onto it;
        keyframes before the window are untouched."""
        self.kf_q[i0:i0 + wn] = g_q[:wn]
        self.kf_t[i0:i0 + wn] = g_t[:wn]
        last = i0 + wn - 1
        T_mo = se3m.compose(SE3(self.kf_q[last], self.kf_t[last]),
                            se3m.inverse(SE3(self.kf_q_odom[last], self.kf_t_odom[last])))
        if last + 1 < n:
            T_after = se3m.compose(T_mo, SE3(self.kf_q_odom[last + 1:n],
                                             self.kf_t_odom[last + 1:n]))
            self.kf_q[last + 1:n] = T_after.q
            self.kf_t[last + 1:n] = T_after.t
        self.T_map_odom = T_mo

    def optimize_graph(self):
        """Pose-graph optimisation over the loop window [first loop i, last
        loop j] with sequential edges + the accumulated loop edges (thinned to
        cfg.pgo_max_loop_edges), throttled as the reference throttles it.
        Each call is a `pgo` span: route (dense, banded, or throttled when
        it returns without a solve), nodes (the padded window), window,
        loop_edges, and the LM's lm_iters and lm_rejects."""
        with profiling.span("pgo", route="throttled") as sp:
            self._optimize_graph(sp)

    def _optimize_graph(self, sp):
        cfg = self.cfg
        n = self.count
        if not self.closures or n < 2:
            return
        i0 = min(lc.kf_i for lc in self.closures)
        j1 = max(lc.kf_j for lc in self.closures)
        if j1 - self._last_pgo_id <= int(n / 100) * 2:
            return
        wn = j1 - i0 + 1
        n_pad = max(32, 1 << (wn - 1).bit_length())
        closures = self.closures
        cap = cfg.pgo_max_loop_edges
        if cap > 0 and len(closures) > cap:
            order = sorted(closures, key=lambda c: c.kf_j)
            bounds = np.linspace(0, len(order), cap + 1).astype(int)
            closures = [max(order[a:b], key=lambda c: c.num_inliers)
                        for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        L = len(closures)
        loop_pad = max(8, 8 * ((L + 7) // 8))
        loop_i = np.full(loop_pad, i0, np.int64)
        loop_j = np.full(loop_pad, i0, np.int64)
        loop_q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (loop_pad, 1))
        loop_t = np.zeros((loop_pad, 3), np.float32)
        loop_valid = np.zeros(loop_pad, bool)
        # A closure's T_ij lives on the host (_verify_accept): no device read.
        for e, lc in enumerate(closures):
            loop_i[e], loop_j[e] = lc.kf_i, lc.kf_j
            loop_q[e] = lc.T_ij.q.cpu().numpy()
            loop_t[e] = lc.T_ij.t.cpu().numpy()
            loop_valid[e] = True
        g = self._build_graph(i0, wn, loop_i, loop_j, loop_q, loop_t, loop_valid,
                              n_pad, cfg.seq_edge_successors)
        fixed = torch.zeros(n_pad, dtype=torch.bool, device=self.device)
        with profiling.host_sync("pgo.fixed"):          # the scalar is uploaded from the host
            fixed[0] = True
        if self.dump_dir is not None:
            self._dump_graph(f"{self.count:05d}_before")
        if self.pgo_device is not None:
            g = tree_map(lambda a: a.to(self.pgo_device), g)
            fixed = fixed.to(self.pgo_device)
        sp.set(route="banded" if n_pad > _BANDED_THRESHOLD else "dense", nodes=n_pad,
               window=wn, loop_edges=L)
        if n_pad > _BANDED_THRESHOLD:
            # _build_graph puts the n_succ·n_pad sequential edges first: the band.
            solved = pose_graph.optimize_banded(
                g, fixed, band_edges=cfg.seq_edge_successors * n_pad,
                iters=min(cfg.pgo_iters, 20))
        else:
            solved = pose_graph.optimize(g, fixed, iters=min(cfg.pgo_iters, 30))
        g2 = solved[0]
        sp.set(lm_iters=solved.lm_iters, lm_rejects=solved.lm_rejects)
        # The solved poses back next to the pose tables.
        self._apply_pgo(g2.node_q.to(self.device), g2.node_t.to(self.device), i0, wn, n)
        self._last_pgo_id = j1
        if self.dump_dir is not None:
            self._dump_graph(f"{self.count:05d}_after")

    # ---------------------------------------------------------------- query
    def corrected_pose(self, T_c_w_odom: SE3) -> SE3:
        """Apply the current drift estimate to a frontend odometry pose."""
        T = SE3(T_c_w_odom.q.to(self.device), T_c_w_odom.t.to(self.device))
        return se3m.inverse(se3m.compose(self.T_map_odom, se3m.inverse(T)))
