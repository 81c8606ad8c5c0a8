"""Copy of flvis_tpu/config.py (the port keeps its own; it imports nothing of flvis_tpu).

Configuration for the TPU-native SLAM engine.

Mirrors the reference's single-YAML parameter surface (read through
the upstream FLVIS src/utils/include/yamlRead.h; full parameter list inventoried
in SURVEY.md §5: type_of_vi, intrinsics/extrinsics, vifusion_para1..6,
feature_para1..6, dr_para1..3, window_size, loop params lcKF*/ratio*/minScore,
plus the hardcoded constants 0.05 m / 0.2 rad keyframe gates, chi²=3,
min-inliers 10, 16 grid cells, 31×31 LK window).

Static (shape-determining / branch-determining) values live in this frozen
dataclass so it can be a jit static argument; per-sequence numeric values
(intrinsics, extrinsics) travel separately as arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class ViType:
    """Sensor configurations (vi_type.h:4-9 in the reference)."""

    D435I_DEPTH = 0
    EUROC_MAV = 1
    D435_DEPTH_PIXHAWK = 2
    D435I_STEREO = 3
    KITTI_STEREO = 4
    D435_STEREO_PIXHAWK = 5


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    # --- image / capacity (static shapes) ---
    width: int = 752
    height: int = 480
    num_slots: int = 256            # landmark table capacity (16 cells × 16)
    pyramid_levels: int = 4
    # Depth source: False = rectified stereo (img1 is the right image);
    # True = RGB-D (img1 is a raw depth image, VI_TYPE_D435I_DEPTH mode).
    depth_mode: bool = False

    # --- feature detection (feature_para*, vo_tracking.cpp:126-134) ---
    grid_rows: int = 4
    grid_cols: int = 4
    per_cell: int = 16
    min_distance: float = 15.0
    quality_level: float = 0.01
    margin: int = 20

    # --- LK tracking (lkorb_tracking.cpp: 31×31 window, 10 levels) ---
    # The reference's 31×31 window compensates for having no motion prior on
    # some paths; with the IMU/constant-velocity prior + F-gate + robust BA,
    # a 15×15 window measures identically (validated on the synthetic golden
    # runs) at ~2× less patch work.
    lk_radius: int = 7
    # 6 GN iterations: points still moving after 6 shift by <0.2 px (below
    # the pose noise floor) and the sequential GN chain is the frontend's
    # dominant TPU latency (tools/sweep_operating_point.py: equal-or-better
    # ATE vs 10 iterations at EuRoC scale).
    lk_iters: int = 6
    lk_min_eig: float = 1e-4

    # --- geometric gates ---
    ransac_threshold: float = 3.0       # F-matrix Sampson gate, px
    ransac_hypotheses: int = 128
    min_inliers: int = 10               # failure threshold (ref: <10 at any stage)
    # Prior-free PnP RANSAC rescue when motion-BA inliers starve — the
    # reference's per-frame cv::solvePnPRansac role (lkorb_tracking.cpp:
    # 161-200).  Disable for vmapped batches (cond→select runs it always).
    pnp_fallback: bool = True
    chi2_cull: float = 9.0              # BA edge cull (ref chi²>3 on ~(px/σ)²)
    huber_delta: float = 2.0
    mad_sigma: float = 3.0

    # --- depth recovery (dr_para1..3) ---
    iir_ratio: float = 0.3              # depth innovation IIR blend
    depth_min: float = 0.1
    depth_max: float = 100.0
    tri_min_baseline: float = 0.2       # motion-triangulation baseline gate (m)
    dummy_depth: bool = False           # stereo bootstrap dummy depth enable
    dummy_depth_range: tuple = (0.3, 0.7)
    innovation_gate: float = 0.3        # relative depth-jump rejection

    # --- keyframe decision (f2f_tracking.cpp:338-354) ---
    kf_min_trans: float = 0.05          # metres
    kf_min_rot: float = 0.2             # radians
    kf_bootstrap_every: int = 5         # every 5th of the first 40 frames
    kf_bootstrap_frames: int = 40

    # --- motion-only BA schedule ---
    ba_iters1: int = 3
    ba_iters2: int = 5

    # --- equalization (f2f_tracking.cpp:127-148) ---
    equalize: bool = False


@dataclasses.dataclass(frozen=True)
class VioConfig:
    """VIMOTION parameters (vifusion_para1..6, vo_tracking.cpp:116-124)."""

    imu_capacity: int = 400             # state deque bound (vi_motion.h:10)
    madgwick_beta: float = 0.05         # para_1
    rp_blend: float = 0.05              # para_2: roll/pitch feedforward weight
    acc_bias_gain: float = 0.01         # para_3
    gyro_bias_gain: float = 0.01        # para_4
    acc_bias_sat: float = 0.5           # ba_sat
    gyro_bias_sat: float = 0.1          # bw_sat
    gravity: float = 9.81
    init_samples: int = 30              # Madgwick init window (vi_motion.cpp:34-115)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Sliding-window BA (vo_localmap.cpp:382-469)."""

    window_size: int = 10               # clamped [3,100] in the reference
    max_landmarks: int = 1024           # fixed landmark-slot capacity in the window
    min_views: int = 4                  # multi-view export filter (vo_localmap.cpp:330)
    iters1: int = 12                    # optimize(12)
    iters2: int = 8                     # → cull chi²>3 → optimize(8)
    chi2_cull: float = 9.0
    huber_delta: float = 2.0
    # Fused Pallas Schur-step kernel (ops/pallas/schur.py): used on real TPUs
    # for window_size ≤ 16 (larger windows fall back to the XLA path with a
    # loud warning — see window_ba.optimize).  Disable for vmapped/batched
    # windows (multi-sequence DP), where the kernel's batching is unproven.
    pallas_schur: bool = True


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closing (LC_PARAS, vo_loopclosing.cpp:86-97)."""

    max_keyframes: int = 2048           # capacity of the KF database arrays
    # 1000 ORB features per keyframe for place recognition — the reference's
    # extractor budget (vo_loopclosing.cpp:243-245 `ORB::create(1000, ...)`).
    num_orb_features: int = 1000
    vocab_words: int = 4096             # flattened BoW vocabulary size
    kf_start: int = 50                  # min KFs before searching (lcKFStart)
    kf_dist: int = 50                   # temporal gate to candidates (lcKFDist)
    # Candidate search window: the reference searches the HARDCODED 5000
    # keyframes before the temporal gate (vo_loopclosing.cpp:529-534) —
    # distinct from kf_max_dist below, which is only the neighbour radius.
    search_window: int = 5000
    # Neighbour-consistency radius |idx − idx_best| ≤ lcKFMaxDist for the
    # supporting-keyframe count (vo_loopclosing.cpp:568; YAML lcKFMaxDist,
    # e.g. 50 in launch/KITTI/KITTI.yaml).
    kf_max_dist: int = 50
    nkf_closest: int = 3                # neighbour-consistency count (lcNKFClosest)
    ratio_max: float = 0.75             # descriptor ratio test
    ratio_ransac: float = 0.55          # PnP inlier-ratio accept gate
    min_pts: int = 15
    min_score: float = 0.02
    max_trans: float = 3.0              # ‖t‖ accept gate (vo_loopclosing.cpp:686)
    max_rot: float = 1.5                # ‖log R‖ accept gate
    pgo_iters: int = 100                # optimize(100)
    # Loop-edge budget per PGO solve.  The reference accumulates EVERY
    # accepted closure and rebuilds the whole edge set each event
    # (loop_ids.push_back, vo_loopclosing.cpp:484-486) — fine for sparse
    # CPU g2o, but here loop edges enter the O(n) banded solver as a
    # rank-6L Woodbury correction, so a sustained revisit (a closure per
    # keyframe) would grow a dense (6L, 6L) solve without bound and churn
    # a fresh compile per 8-edge bucket.  Past this budget the solve thins
    # to the strongest closure (most PnP inliers) per window bucket —
    # consecutive (i,j),(i+1,j+1),... closures are near-duplicate
    # constraints, so coverage, not count, is what conditions the graph.
    # The full closure list is kept for stats/export.  0 disables.
    pgo_max_loop_edges: int = 64
    # Geometric-verification RANSAC budget: the reference hardcodes
    # iterationsCount=100 in its solvePnPRansac call
    # (vo_loopclosing.cpp:670); here the P3P hypotheses are batched and
    # scored in one device program, so the budget is a hypothesis count.
    ransac_hypotheses: int = 128
    seq_edge_successors: int = 5        # sequential edges to 5 successors
    # In-run vocabulary refresh: a vocabulary trained on the first 8
    # keyframes biases words to the opening scene; once this many keyframes
    # exist the vocabulary is retrained on the whole run and every BoW row
    # back-filled (one batched program).  0 disables; pretrained
    # vocabularies (the reference's DBoW3-file path) are never refreshed.
    vocab_refresh_at: int = 64


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    vi_type: int = ViType.EUROC_MAV
    frontend: FrontendConfig = FrontendConfig()
    vio: VioConfig = VioConfig()
    backend: BackendConfig = BackendConfig()
    loop: LoopConfig = LoopConfig()

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def load_yaml(path: str) -> SystemConfig:
    """Build a SystemConfig from a reference-style YAML file.

    Reads the same keys the reference's yamlRead.h getters consume
    (feature_para*, vifusion_para*, dr_para*, window_size, lc params).
    Unknown keys are ignored; missing keys keep defaults.
    """
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f) or {}

    fe = {}
    if "image_width" in y:
        fe["width"] = int(y["image_width"])
    if "image_height" in y:
        fe["height"] = int(y["image_height"])
    if "feature_para1" in y:
        fe["per_cell"] = int(y["feature_para1"])
    if "feature_para3" in y:
        fe["min_distance"] = float(y["feature_para3"])
    if "feature_para5" in y:
        fe["quality_level"] = float(y["feature_para5"])
    dr = {}
    if "dr_para1" in y:
        dr["iir_ratio"] = float(y["dr_para1"])
    if "dr_para2" in y:
        dr["depth_max"] = float(y["dr_para2"])
    if "dr_para3" in y:
        dr["dummy_depth"] = bool(y["dr_para3"])
    vio = {}
    if "vifusion_para1" in y:
        vio["madgwick_beta"] = float(y["vifusion_para1"])
    if "vifusion_para2" in y:
        vio["rp_blend"] = float(y["vifusion_para2"])
    if "vifusion_para3" in y:
        vio["acc_bias_gain"] = float(y["vifusion_para3"])
    if "vifusion_para4" in y:
        vio["gyro_bias_gain"] = float(y["vifusion_para4"])
    if "vifusion_para5" in y:
        vio["acc_bias_sat"] = float(y["vifusion_para5"])
    if "vifusion_para6" in y:
        vio["gyro_bias_sat"] = float(y["vifusion_para6"])
    be = {}
    if "window_size" in y:
        be["window_size"] = max(3, min(100, int(y["window_size"])))
    lc = {}
    # lcKFLast is read by the reference but never used (vo_loopclosing.cpp:
    # 91,958 — dead parameter); it is intentionally not mapped.
    for src, dst in [("lcKFStart", "kf_start"), ("lcKFDist", "kf_dist"),
                     ("lcKFMaxDist", "kf_max_dist"),
                     ("lcNKFClosest", "nkf_closest"), ("ratioMax", "ratio_max"),
                     ("ratioRansac", "ratio_ransac"), ("minPts", "min_pts"),
                     ("minScore", "min_score")]:
        if src in y:
            default = LoopConfig.__dataclass_fields__[dst].default
            lc[dst] = type(default)(y[src])

    vi_type = int(y.get("type_of_vi", ViType.EUROC_MAV))
    # Depth modes interpret the second image as an aligned depth map.
    fe["depth_mode"] = vi_type in (ViType.D435I_DEPTH, ViType.D435_DEPTH_PIXHAWK)
    return SystemConfig(
        vi_type=vi_type,
        frontend=FrontendConfig(**fe, **dr),
        vio=VioConfig(**vio),
        backend=BackendConfig(**be),
        loop=LoopConfig(**lc),
    )
