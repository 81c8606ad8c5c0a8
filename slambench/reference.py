"""The plain reference that decides `correct`: the ground truth of the
generator's laps, a pose-graph solve of its own, and the numbers that hold
the program's outputs to them.

Plain NumPy.  It imports nothing of the program: it reads the program's
outputs only to judge them, and works the truth out again from what the
generator made (stream.gt_centres, the laps' camera centres in the world
frame of the scene; the camera never rotates).  The arithmetic of ATE is
copied from flvis_tpu_torch/utils/evaluation.py at commit 1a1c6dc.

PGO is followed from the program's own state: its keyframes' odometry
poses, the loop edges its verification measured, and the points at which
its loop node offered closures to PGO.  From those the reference solves
the pose graph again (FLVIS's semantics: the window from the first loop
keyframe to the last, sequential edges to `seq_edge_successors`
successors with weight 1/s, loop edges thinned to `max_loop_edges` with
weight `loop_edge_weight`, a Cauchy loss, the window's first node fixed,
the keyframes after it re-based onto the new drift; re-solved only once
the newest loop is more than 2 % of the keyframes past the last solve),
in float64 Gauss-Newton to convergence.

Numbers (each in mm unless a count; every sequence; the frames due in
the window and after it, the answers a run times; set-up's frames are
left out):
  missing         frames whose pose never reached the host (count)
  not_tracking    frames whose status is not TRACKING (count)
  frame_step_mm   the largest error of a frame's motion since the previous
                  frame, in the previous camera's frame, against the truth
                  (the frame step's per-frame pose)
  frame_step_rms_mm  the same errors' RMS
  pgo_gap_mm      the largest distance between a keyframe's corrected
                  position (the loop node's node poses) and the reference
                  solve's
  no_closure      sequences whose window revisited places and accepted no
                  closure whose newer keyframe came in the window (count)
Reported, not compared:
  ba_window_mm    the step error between consecutive keyframes of window
                  BA's final window
  loop_edge_mm    the largest error of an accepted loop edge's translation
                  against the truth's
  new_closures    the fewest such closures of a revisiting sequence
  ate_mm          the odometry's ATE RMSE without alignment (the frame
                  origin being the first frame's)
"""

from __future__ import annotations

import numpy as np

# The numbers the judge can compare, in the order they are printed.
NUMBERS = ("missing", "not_tracking", "frame_step_mm", "frame_step_rms_mm", "pgo_gap_mm",
           "no_closure")
COUNTS = ("missing", "not_tracking", "no_closure")


# ---------------------------------------------------------------- poses
def quat_to_matrix(q) -> np.ndarray:
    """(..., 4) unit quaternions (w, x, y, z) → (..., 3, 3), float64."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    m = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def centres_of_T_c_w(q, t):
    """(R_c_w (N, 3, 3), camera centres C = -Rᵀ t (N, 3)) of T_c_w poses."""
    R = quat_to_matrix(q)
    return R, -np.einsum("nji,nj->ni", R, np.asarray(t, np.float64))


def qmul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw],
                    -1)


def qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def qrot(q, v):
    return np.einsum("...ij,...j->...i", quat_to_matrix(q), v)


def compose(a, b):
    """a ∘ b of (q, t) poses (apply b first)."""
    q = qmul(a[0], b[0])
    return q / np.linalg.norm(q, axis=-1, keepdims=True), qrot(a[0], b[1]) + a[1]


def inverse(T):
    qi = qconj(T[0])
    return qi, -qrot(qi, T[1])


def so3_exp(phi):
    th = np.linalg.norm(phi, axis=-1, keepdims=True)
    small = th < 1e-8
    k = np.where(small, 0.5 - th * th / 48.0, np.sin(0.5 * th) / np.where(small, 1.0, th))
    return np.concatenate([np.cos(0.5 * th), k * phi], -1)


def so3_log(q):
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    n = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    small = n < 1e-12
    th = 2.0 * np.arctan2(n, np.clip(q[..., :1], -1.0, 1.0))
    return np.where(small, 2.0 / np.clip(q[..., :1], 0.5, None), th / np.where(small, 1.0, n)) \
        * q[..., 1:]


def se3_exp(xi):
    """Twist (..., 6) [rho, phi] → (q, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = np.sum(phi * phi, -1, keepdims=True)
    th = np.sqrt(th2)
    small = th2 < 1e-12
    ths, th2s = np.where(small, 1.0, th), np.where(small, 1.0, th2)
    a = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th)) / th2s)
    b = np.where(small, 1.0 / 6.0 - th2 / 120.0, (th - np.sin(th)) / (th2s * ths))
    cr = np.cross(phi, rho)
    return so3_exp(phi), rho + a * cr + b * np.cross(phi, cr)


def se3_log(T):
    """(q, t) → twist (..., 6) [rho, phi]."""
    phi = so3_log(T[0])
    th2 = np.sum(phi * phi, -1, keepdims=True)
    th = np.sqrt(th2)
    small = th2 < 1e-12
    half = 0.5 * np.where(small, 1.0, th)
    cot = np.where(small, 1.0 / 12.0 + th2 / 720.0,
                   (1.0 - half * np.cos(half) / np.sin(half)) / np.where(small, 1.0, th2))
    cr = np.cross(phi, T[1])
    return np.concatenate([T[1] - 0.5 * cr + cot * np.cross(phi, cr), phi], -1)


# ------------------------------------------------------------------ PGO
def _edge_log(Ti, Tj, eq, et):
    """r_e = log(T_ij⁻¹ · T_i⁻¹ · T_j) of every edge, (E, 6)."""
    return se3_log(compose(inverse((eq, et)), compose(inverse(Ti), Tj)))


def _cost(r, w, c):
    return float(np.sum(w * c * c * np.log1p(np.sum(r * r, -1) / (c * c))))


def solve_pose_graph(nq, nt, ii, jj, eq, et, ew, cauchy_c: float, iters: int = 50):
    """Minimise Σ_e ew_e · c² log(1 + |r_e|²/c²) over the nodes T_k exp ξ_k
    (node 0 held fixed): float64 Gauss-Newton on the Cauchy weights with
    central-difference Jacobians, each step damped until the cost falls.
    Returns the nodes (q (K, 4), t (K, 3))."""
    nq, nt = np.array(nq, np.float64), np.array(nt, np.float64)
    K, E = len(nq), len(ii)
    r = _edge_log((nq[ii], nt[ii]), (nq[jj], nt[jj]), eq, et)
    cost = _cost(r, ew, cauchy_c)
    h, lam = 1e-6, 1e-9
    for _ in range(iters):
        ends = [(nq[ii], nt[ii]), (nq[jj], nt[jj])]
        J = np.zeros((E, 6, 12))
        for side in (0, 1):
            for d in range(6):
                xi = np.zeros((E, 6))
                xi[:, d] = h
                moved = [list(ends), list(ends)]
                moved[0][side] = compose(ends[side], se3_exp(xi))
                moved[1][side] = compose(ends[side], se3_exp(-xi))
                J[:, :, 6 * side + d] = (_edge_log(*moved[0], eq, et)
                                         - _edge_log(*moved[1], eq, et)) / (2 * h)
        w = ew / (1.0 + np.sum(r * r, -1) / (cauchy_c * cauchy_c))
        Jw = J * w[:, None, None]
        H = np.zeros((K, K, 6, 6))
        g = np.zeros((K, 6))
        for a, ia in ((0, ii), (1, jj)):
            np.add.at(g, ia, -np.einsum("eki,ek->ei", Jw[:, :, 6 * a:6 * a + 6], r))
            for b, ib in ((0, ii), (1, jj)):
                np.add.at(H, (ia, ib), np.einsum("eki,ekj->eij", Jw[:, :, 6 * a:6 * a + 6],
                                                 J[:, :, 6 * b:6 * b + 6]))
        Hd = H.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)[6:, 6:]
        gd = g.reshape(-1)[6:]
        while True:
            dx = np.linalg.solve(Hd + lam * np.diag(np.diag(Hd)), gd)
            q2, t2 = compose((nq, nt), se3_exp(np.concatenate([np.zeros(6), dx]).reshape(K, 6)))
            r2 = _edge_log((q2[ii], t2[ii]), (q2[jj], t2[jj]), eq, et)
            cost2 = _cost(r2, ew, cauchy_c)
            if cost2 <= cost or lam > 1e6:
                break
            lam *= 10.0
        if cost2 > cost:
            break
        done = np.max(np.abs(dx)) < 1e-9 or cost - cost2 <= 1e-15 * cost
        nq, nt, r, cost = q2, t2, r2, cost2
        lam = max(lam / 10.0, 1e-12)
        if done:
            break
    return nq, nt


def pgo_reference(odom_q, odom_t, edges, calls, n_final: int, pgo: dict):
    """The loop node's corrected keyframe poses (T_w_c (q, t), float64,
    keyframes 0..n_final-1) as the reference works them out.
      odom_q, odom_t  the keyframes' odometry poses T_w_c (n_final rows)
      edges     the accepted loop edges in order: (kf_i, kf_j, inliers,
                q_ij (4,), t_ij (3,))
      calls     (closures accepted, keyframes) at each of the loop node's
                PGO calls; every closure is offered to PGO by the run's end
    Returns (q, t, solved): solved is False where no solve was due."""
    oq = np.asarray(odom_q, np.float64)[:n_final]
    oq = oq / np.linalg.norm(oq, axis=-1, keepdims=True)
    ot = np.asarray(odom_t, np.float64)[:n_final]
    last, due = -5000, None
    for c, n in list(calls) + [(len(edges), n_final)]:
        if c == 0 or n < 2:
            continue
        j1 = max(e[1] for e in edges[:c])
        if j1 - last <= int(n / 100) * 2:
            continue
        last, due = j1, c
    if due is None:
        return oq, ot, False
    used = list(edges[:due])
    cap = int(pgo["max_loop_edges"])
    i0, j1 = min(e[0] for e in used), max(e[1] for e in used)
    if cap > 0 and len(used) > cap:
        order = sorted(used, key=lambda e: e[1])
        bounds = np.linspace(0, len(order), cap + 1).astype(int)
        used = [max(order[a:b], key=lambda e: e[2]) for a, b in zip(bounds[:-1], bounds[1:])
                if b > a]
    wn = j1 - i0 + 1
    wq, wt = oq[i0:j1 + 1], ot[i0:j1 + 1]
    ii, jj, eq, et, ew = [], [], [], [], []
    for s in range(1, int(pgo["seq_edge_successors"]) + 1):
        a = np.arange(wn - s)
        rq, rt = compose(inverse((wq[a], wt[a])), (wq[a + s], wt[a + s]))
        ii.append(a), jj.append(a + s), eq.append(rq), et.append(rt)
        ew.append(np.full(len(a), 1.0 / s))
    ii.append(np.array([e[0] - i0 for e in used]))
    jj.append(np.array([e[1] - i0 for e in used]))
    eq.append(np.array([e[3] for e in used], np.float64).reshape(-1, 4))
    et.append(np.array([e[4] for e in used], np.float64).reshape(-1, 3))
    ew.append(np.full(len(used), float(pgo["loop_edge_weight"])))
    sq, st = solve_pose_graph(wq, wt, np.concatenate(ii), np.concatenate(jj),
                              np.concatenate(eq), np.concatenate(et), np.concatenate(ew),
                              float(pgo["cauchy_c"]))
    q, t = oq.copy(), ot.copy()
    q[i0:j1 + 1], t[i0:j1 + 1] = sq, st
    T_mo = compose((sq[-1], st[-1]), inverse((oq[j1], ot[j1])))
    if j1 + 1 < n_final:
        q[j1 + 1:], t[j1 + 1:] = compose((np.broadcast_to(T_mo[0], (n_final - j1 - 1, 4)),
                                          np.broadcast_to(T_mo[1], (n_final - j1 - 1, 3))),
                                         (oq[j1 + 1:], ot[j1 + 1:]))
    return q, t, True


# -------------------------------------------------------------- numbers
def step_errors(R_cw, C, G) -> np.ndarray:
    """‖R_cw[k-1] (C[k] - C[k-1]) - (G[k] - G[k-1])‖ for k ≥ 1, metres: the
    error of each step's motion in the earlier camera's frame (the truth's
    camera frame is the world's: it never rotates)."""
    if len(C) < 2:
        return np.zeros(0)
    d = np.einsum("nij,nj->ni", R_cw[:-1], C[1:] - C[:-1])
    return np.linalg.norm(d - (G[1:] - G[:-1]), axis=-1)


def ate_rmse(est, gt) -> float:
    """ATE RMSE in metres without alignment (evaluation.ate_rmse's
    align=False branch)."""
    err = np.linalg.norm(np.asarray(est, float) - np.asarray(gt, float), axis=1)
    return float(np.sqrt(np.mean(err ** 2))) if len(err) else 0.0


def truth(gt_lap: np.ndarray, frame_ids) -> np.ndarray:
    """Camera centres of stream frames `frame_ids` of one sequence, relative
    to its first frame's (the program starts at the identity)."""
    ids = np.asarray(frame_ids, np.int64)
    return gt_lap[ids % len(gt_lap)] - gt_lap[0]


def sequence_numbers(seq: dict, gt_lap: np.ndarray, pgo: dict) -> dict:
    """The numbers of one sequence.  seq holds the program's outputs:
      frames        stream frames expected (int)
      first         the first frame the window drove (int)
      frame_id, status, q, t   the frames whose pose reached the host
                    (T_c_w rows)
      ba            (frame_id, q, t) of window BA's valid keyframes (T_c_w)
      loop          None without a loop node, else a dict:
        frame_id, q, t        the corrected keyframe poses (T_w_c)
        odom_q, odom_t        the keyframes' odometry poses (T_w_c)
        edges       accepted loop edges (kf_i, kf_j, inliers, q_ij, t_ij)
        calls       (closures, keyframes) at each PGO call
        at_window   keyframes the loop node held when the window opened
    """
    n, first = int(seq["frames"]), int(seq.get("first", 0))
    fid = np.asarray(seq["frame_id"], np.int64)
    got = np.zeros(n, bool)
    got[fid[(fid >= 0) & (fid < n)]] = True
    timed = fid >= first
    out = {"missing": int(n - first - got[first:].sum()),
           "not_tracking": int(np.sum(np.asarray(seq["status"])[timed] != 1))}
    order = np.argsort(fid, kind="stable")
    fid = fid[order]
    R, C = centres_of_T_c_w(np.asarray(seq["q"])[order], np.asarray(seq["t"])[order])
    G = truth(gt_lap, fid)
    judged = (np.diff(fid) == 1) & (fid[1:] >= first)
    e = step_errors(R, C, G)[judged]
    out["frame_step_mm"] = 1e3 * float(e.max()) if len(e) else 0.0
    out["frame_step_rms_mm"] = 1e3 * float(np.sqrt(np.mean(e ** 2))) if len(e) else 0.0
    out["ate_mm"] = 1e3 * ate_rmse(C, G)

    b_fid, b_q, b_t = seq["ba"]
    o = np.argsort(b_fid)
    Rb, Cb = centres_of_T_c_w(np.asarray(b_q)[o], np.asarray(b_t)[o])
    eb = step_errors(Rb, Cb, truth(gt_lap, np.asarray(b_fid)[o]))
    out["ba_window_mm"] = 1e3 * float(eb.max()) if len(eb) else 0.0

    lp = seq.get("loop")
    if lp is not None:
        kf = np.asarray(lp["frame_id"], np.int64)
        n_kf = len(kf)
        rq, rt, _ = pgo_reference(lp["odom_q"], lp["odom_t"], lp["edges"], lp["calls"], n_kf,
                                  pgo)
        gap = np.linalg.norm(np.asarray(lp["t"], np.float64)[:n_kf] - rt, axis=-1)
        out["pgo_gap_mm"] = 1e3 * float(gap.max()) if n_kf else 0.0
        edges = lp["edges"]
        if edges:
            # T_ij's translation is keyframe j's centre in keyframe i's frame;
            # the truth's camera frame is the world's.
            Gk = truth(gt_lap, kf)
            err = [np.linalg.norm(np.asarray(t, np.float64) - (Gk[j] - Gk[i]))
                   for i, j, _, _, t in edges]
            out["loop_edge_mm"] = 1e3 * float(max(err))
        new = sum(e[1] >= int(lp["at_window"]) for e in edges)
        revisited = first >= len(gt_lap) and n > first
        out["new_closures"] = new if revisited else None
        out["no_closure"] = int(revisited and new == 0)
    return out


def numbers(seqs: list, gt: np.ndarray, pgo: dict) -> dict:
    """Every number over all sequences: counts summed, the fewest new
    closures, errors their worst."""
    per = [sequence_numbers(s, gt[i], pgo) for i, s in enumerate(seqs)]
    out = {}
    for k in per[0]:
        vals = [p[k] for p in per if p.get(k) is not None]
        if not vals:
            out[k] = None
        elif k in COUNTS:
            out[k] = sum(vals)
        else:
            out[k] = min(vals) if k == "new_closures" else max(vals)
    return out


def judge(nums: dict, limits: dict):
    """(correct, checks): every number with a limit compared with it; a
    number that a limit names and the run did not give fails."""
    checks = {}
    ok = bool(limits)
    for k in NUMBERS:
        if k not in limits:
            continue
        v = nums.get(k)
        lim = float(limits[k]["limit"])
        checks[k] = {"value": v, "limit": lim}
        ok = ok and v is not None and v <= lim
    return ok, checks


def round_to(a, dtype) -> np.ndarray:
    """a rounded to `dtype` (a numpy dtype, or "bfloat16": round to nearest
    even on float32's upper 16 bits), back as float64."""
    a = np.asarray(a, np.float64)
    if dtype != "bfloat16":
        return a.astype(dtype).astype(np.float64)
    b = a.astype(np.float32).view(np.uint32)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return b.view(np.float32).astype(np.float64)
