"""The loop node's verification over a bucket of candidate pairs, against
the JAX package: the batched mutual-ratio matcher's plain version, the
batched PnP RANSAC, and `LoopCloser._verify_device_batch` with the
reference's 8-wide bucket padding.

Inputs are made from a seed with numpy: descriptors with planted ties
(duplicates, rows whose two nearest are equally far) and masks, and a small
resident store of 6 keyframes (64 features each) seeing one set of world
points, whose node poses carry a drift.  The reference's random draws
(jax.random.uniform under PRNGKey(i·7919 + j)) are handed to the port.
Tolerances:
  - the matcher's outputs: exact (integer);
  - batched PnP against B unbatched calls of the port: exact (the same
    float32 operations on the same numbers);
  - `_verify_device_batch` against the JAX `_verify_device_batch`: n_match
    and n_inl exact; T_ij, |Δt| and |Δlog R| within POSE_TOL = 5e-4
    (measured ≤ 1.2e-4): the winning hypothesis is one 6-point EPnP solve,
    in float32 in each framework (Gram-Schmidt null space, power
    iteration), fed the same minimal sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.config import LoopConfig as JLoopConfig
from flvis_tpu.loop import loop_closing as jlc
from flvis_tpu.ops import orb as jorb
from flvis_tpu_torch.config import LoopConfig
from flvis_tpu_torch.geometry import camera as tcam
from flvis_tpu_torch.loop import loop_closing as tlc
from flvis_tpu_torch.ops import pnp
from flvis_tpu_torch.ops.kernels import hamming

torch.set_num_threads(1)
POSE_TOL = 5e-4
F, K, M = 64, 6, 16                    # features, keyframes, RANSAC hypotheses
CAM = (200.0, 200.0, 128.0, 96.0, 0.12)


def _descriptors(rng, b, na, nb):
    """B pairs of (Na, 8) / (Nb, 8) uint32 descriptors: each a's first rows
    planted near b's rows (a few bits flipped), b holding duplicates (ties
    in a row's argmin and d1 = d2) and a's rows 3-4 equidistant from two b
    rows; validity with masked rows and columns, one all-invalid a row."""
    a = rng.integers(0, 2 ** 32, (b, na, 8), dtype=np.uint32)
    bb = rng.integers(0, 2 ** 32, (b, nb, 8), dtype=np.uint32)
    for p in range(b):
        src = rng.permutation(nb)[: na // 2]
        flips = rng.integers(0, 256, (na // 2, 3))
        for r, (s, fl) in enumerate(zip(src, flips)):
            a[p, r] = bb[p, s]
            for f in fl:
                a[p, r, f // 32] ^= np.uint32(1 << (f % 32))
        bb[p, nb - 1] = bb[p, src[0]]                  # a duplicate column
        bb[p, nb - 2] = bb[p, src[1]]
        a[p, 3] = bb[p, src[3]]                        # equidistant from two columns
        bb[p, nb - 3] = bb[p, src[3]]
        bb[p, nb - 3, 0] ^= np.uint32(1)
        bb[p, src[3], 1] ^= np.uint32(1)
    va = rng.uniform(size=(b, na)) > 0.15
    vb = rng.uniform(size=(b, nb)) > 0.15
    va[:, 2] = True
    vb[:, nb - 1] = vb[:, nb - 2] = True
    va[0, 5] = False
    vb[-1] &= np.arange(nb) % 5 != 0
    return a, bb, va, vb


def _t(x):
    return torch.as_tensor(x.view(np.int32) if x.dtype == np.uint32 else x)


@pytest.mark.parametrize("na,nb", [(40, 33), (17, 5)])
def test_mutual_ratio_match_plain_batch_matches_jax(na, nb):
    """mutual_ratio_match_plain at B = 3 against the JAX matcher pair by
    pair (best_ab, good), and d1, d2, best_ba against numpy on the same
    masked distances (stable order: lowest index first among ties)."""
    rng = np.random.default_rng(na)
    a, b, va, vb = _descriptors(rng, 3, na, nb)
    best_ab, good, d1, d2, best_ba = hamming.mutual_ratio_match_plain(
        _t(a), _t(b), _t(va), _t(vb), ratio=0.8, max_distance=64)
    for p in range(3):
        jb, jg = jorb.mutual_ratio_match(jnp.asarray(a[p]), jnp.asarray(b[p]), jnp.asarray(va[p]),
                                         jnp.asarray(vb[p]), ratio=0.8, max_distance=64)
        np.testing.assert_array_equal(best_ab[p].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(good[p].numpy(), np.asarray(jg))
        x = np.bitwise_xor(a[p][:, None], b[p][None])
        d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
        d = np.where(va[p][:, None] & vb[p][None], d, 512)
        order = np.argsort(d, axis=1, kind="stable")
        np.testing.assert_array_equal(best_ab[p].numpy(), order[:, 0])
        np.testing.assert_array_equal(d1[p].numpy(), np.take_along_axis(d, order, 1)[:, 0])
        np.testing.assert_array_equal(d2[p].numpy(), np.take_along_axis(d, order, 1)[:, 1])
        np.testing.assert_array_equal(best_ba[p].numpy(), np.argmin(d, axis=0))
    assert good.any() and not good[0, 5]
    assert ((d1 == d2) & (d1 < 512)).any()        # the planted ties are there


def test_orb_match_is_a_bucket_of_one():
    rng = np.random.default_rng(7)
    a, b, va, vb = _descriptors(rng, 1, 30, 26)
    got = tlc.orb.mutual_ratio_match(_t(a[0]), _t(b[0]), _t(va[0]), _t(vb[0]), ratio=0.75)
    ref = hamming.mutual_ratio_match_plain(_t(a), _t(b), _t(va), _t(vb), ratio=0.75)
    assert torch.equal(got[0], ref[0][0]) and torch.equal(got[1], ref[1][0])



def test_hamming_on_cpu_takes_the_plain_versions():
    """On CPU tensors both dispatchers run the plain versions and launch
    nothing; the kernel wrappers refuse CPU tensors."""
    rng = np.random.default_rng(11)
    a, b, va, vb = map(_t, _descriptors(rng, 2, 20, 12))
    launches = (hamming.mutual_ratio_match_kernel.launches,
                hamming.hamming_matrix_kernel.launches)
    got = hamming.mutual_ratio_match(a, b, va, vb)
    ref = hamming.mutual_ratio_match_plain(a, b, va, vb)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert torch.equal(hamming.hamming_matrix(a[0], b[0]), hamming.hamming_matrix_plain(a[0], b[0]))
    assert launches == (hamming.mutual_ratio_match_kernel.launches,
                        hamming.hamming_matrix_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        hamming.mutual_ratio_match_kernel(a, b, va, vb)
    with pytest.raises(ValueError, match="CUDA"):
        hamming.hamming_matrix_kernel(a[0], b[0])

def _pnp_problem(rng, n):
    """n world points, a pose, noisy normalised projections with outliers."""
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3))
    ang = rng.normal(0, 0.05, 3)
    c, s = np.cos(ang[1]), np.sin(ang[1])
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    t = rng.normal(0, 0.2, 3)
    pc = X @ R.T + t
    xn = pc[:, :2] / pc[:, 2:] + rng.normal(0, 0.001, (n, 2))
    xn[rng.uniform(size=n) < 0.2] += 0.3
    valid = rng.uniform(size=n) > 0.1
    f = np.float32
    return X.astype(f), xn.astype(f), valid


def test_pnp_ransac_batched_equals_unbatched():
    """A leading pair axis gives each pair's unbatched result, bit for bit."""
    rng = np.random.default_rng(3)
    probs = [_pnp_problem(rng, F) for _ in range(3)]
    scores = torch.as_tensor(rng.uniform(size=(3, M, F)), dtype=torch.float32)
    X, xn, v = (torch.as_tensor(np.stack(z)) for z in zip(*probs))
    T, inl, n = pnp.pnp_ransac(scores, X, xn, v, threshold_n=0.015)
    assert T.q.shape == (3, 4) and inl.shape == (3, F) and n.shape == (3,)
    for p in range(3):
        Tp, inlp, np_ = pnp.pnp_ransac(scores[p], X[p], xn[p], v[p], threshold_n=0.015)
        assert torch.equal(T.q[p], Tp.q) and torch.equal(T.t[p], Tp.t)
        assert torch.equal(inl[p], inlp) and int(n[p]) == int(np_) > F // 2


def _store(seed=5):
    """A resident store of K keyframes over one set of F world points:
    keyframe k at x = 0.1·k (a small yaw), its features a permutation of the
    points with a few descriptor bits flipped, some outliers, masks; the
    node poses carry a drift of 0.01·k in y."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, _ = CAM
    X = rng.uniform([-2, -1.5, 4], [2.5, 1.5, 8], (F, 3))
    base = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    st = {k: [] for k in ("desc", "kpv", "pcv", "pc", "uv", "q", "t")}
    for k in range(K):
        yaw = 0.02 * k
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        C = np.array([0.1 * k, 0.0, 0.0])
        perm = rng.permutation(F)
        pc = (X[perm] - C) @ R                                  # R^T (X - C)
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
        d = base[perm].copy()
        for r, f in enumerate(rng.integers(0, 256, (F, 4))):
            for b in f:
                d[r, b // 32] ^= np.uint32(1 << (b % 32))
        d[rng.uniform(size=F) < 0.15] = rng.integers(0, 2 ** 32, 8, dtype=np.uint32)
        st["desc"].append(d)
        st["kpv"].append(rng.uniform(size=F) > 0.05)
        st["pcv"].append(rng.uniform(size=F) > 0.1)
        st["pc"].append(pc)
        st["uv"].append(uv)
        # T_wc as wxyz: a yaw about y.
        st["q"].append([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        st["t"].append(C + [0.0, 0.01 * k, 0.0])
    f = np.float32
    return {k: np.asarray(v, np.uint32 if k == "desc" else bool if k in ("kpv", "pcv") else f)
            for k, v in st.items()}


def _jax_scores(i, j, m, n, device):
    u = jax.random.uniform(jax.random.PRNGKey(i * 7919 + j), (m, n))
    return torch.as_tensor(np.asarray(u), device=device)


@pytest.fixture(scope="module")
def store_pair():
    """The store in a port LoopCloser (CPU) and as the JAX arrays."""
    st = _store()
    cfg = LoopConfig(max_keyframes=K, num_orb_features=F, ransac_hypotheses=M)
    tl = tlc.LoopCloser(cfg, tcam.make(*CAM, width=256, height=192, device="cpu"),
                        device="cpu")
    tl.kf_desc = _t(st["desc"])
    tl.kf_kp_valid, tl.kf_pc_valid = _t(st["kpv"]), _t(st["pcv"])
    tl.kf_pc, tl.kf_uv = _t(st["pc"]), _t(st["uv"])
    tl.kf_q, tl.kf_t = _t(st["q"]), _t(st["t"])
    tl.count = K
    return st, tl


# The reference pads a bucket with its last pair (loop_closing.py:964-985).
PAIRS = [(0, 3), (1, 4), (2, 5), (0, 5)]
BUCKET = PAIRS + PAIRS[-1:] * (8 - len(PAIRS))


def test_verify_device_batch_matches_jax(store_pair, monkeypatch):
    """A padded bucket of 8 through the port's _verify_device_batch and the
    JAX _verify_device_batch on the same store and draws."""
    st, tl = store_pair
    monkeypatch.setattr(tlc, "_verify_scores", _jax_scores)
    iis, jjs = [p[0] for p in BUCKET], [p[1] for p in BUCKET]
    got = tl._verify_device_batch(iis, jjs).numpy()
    cfg = JLoopConfig(max_keyframes=K, num_orb_features=F, ransac_hypotheses=M)
    keys = jnp.stack([jax.random.PRNGKey(i * 7919 + j) for i, j in BUCKET])
    fx, fy, cx, cy, _ = CAM
    out = jlc._verify_device_batch(
        jnp.asarray(st["desc"]), jnp.asarray(st["kpv"]), jnp.asarray(st["pcv"]),
        jnp.asarray(st["pc"]), jnp.asarray(st["uv"]), jnp.asarray(st["q"]),
        jnp.asarray(st["t"]), jnp.asarray(iis, jnp.int32), jnp.asarray(jjs, jnp.int32),
        fx, fy, cx, cy, keys, cfg.ratio_max, 3.0 / fx, num_hypotheses=M)
    q, t, n_match, n_inl, dt, dr = (np.asarray(x) for x in out)
    assert got.shape == (8, 11)
    np.testing.assert_array_equal(got[:, 7], n_match)
    np.testing.assert_array_equal(got[:, 8], n_inl)
    assert (n_match >= 20).all() and (n_inl >= 15).all()
    # q and −q are one rotation; both packages keep w ≥ 0 here.
    np.testing.assert_allclose(got[:, :4], q, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(got[:, 4:7], t, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(got[:, 9], dt, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(got[:, 10], dr, atol=POSE_TOL, rtol=0)
    assert (dt > 0.005).all()                            # the drift shows
    # The padding repeats the last real pair's row.
    np.testing.assert_array_equal(got[len(PAIRS):], np.broadcast_to(got[len(PAIRS) - 1],
                                                                     (8 - len(PAIRS), 11)))


def test_dispatch_verify_buckets(store_pair, monkeypatch):
    """10 candidates → _verify_device_batch buckets of 8 and 2 (real pairs
    only, no padding), (10, 11) statistics equal to the per-pair
    _verify_device rows."""
    _, tl = store_pair
    monkeypatch.setattr(tlc, "_verify_scores", _jax_scores)
    pairs = [(i, j) for i in range(3) for j in range(3, K)][:9] + [(1, 3)]
    calls = []
    real = tl._verify_device_batch

    def spy(iis, jjs):
        calls.append(list(zip(iis, jjs)))
        return real(iis, jjs)

    monkeypatch.setattr(tl, "_verify_device_batch", spy)
    ks = [j for _, j in pairs]
    rows = np.asarray([[i, 1.0, 10.0, 0.0] for i, _ in pairs], np.float32)
    handle = tl.dispatch_verify(("rows", ks, [0] * len(ks), [K] * len(ks), None), rows)
    assert handle[1] == pairs
    assert calls == [pairs[:8], pairs[8:]]
    monkeypatch.setattr(tl, "_verify_device_batch", real)
    per_pair = torch.stack([tl._verify_device(i, j) for i, j in pairs])
    assert handle[2].shape == (10, 11)
    np.testing.assert_array_equal(handle[2][:, 7:9].numpy(), per_pair[:, 7:9].numpy())
    np.testing.assert_allclose(handle[2].numpy(), per_pair.numpy(), atol=1e-6, rtol=0)
