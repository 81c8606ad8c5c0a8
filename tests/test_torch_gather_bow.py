"""The port's last two kernels' plain versions against the JAX package:
ops/kernels/gather.gather_windows_plain against the TPU kernel
flvis_tpu/ops/pallas/gather.py:gather_windows (interpret mode) and the
package's CPU block gather ops/image._gather_blocks; ops/kernels/bowassign
.bow_tf_plain against flvis_tpu/ops/pallas/bowassign.py:bow_tf_pallas
(interpret mode); and loop/bow.transform_rows against the reference's
batched BoW rows (loop_closing._bow_rows).

Tolerances: the gathers are copies and the term frequencies integer
counts, so both are held with equality; the tf-idf rows within 1e-6
(float32 idf products and the L1 sum order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.loop import loop_closing as jlc
from flvis_tpu.ops import image as jimg
from flvis_tpu.ops.pallas.bowassign import bow_tf_pallas
from flvis_tpu.ops.pallas.gather import gather_windows as jgather_windows
from flvis_tpu_torch.loop import bow as tbow
from flvis_tpu_torch.ops import image as timg, orb as torb
from flvis_tpu_torch.ops.kernels import bowassign, gather

torch.set_num_threads(1)

# (shape, size, pad, n): the LK search window and template block at a small
# level, an ORB patch, and an odd point count.
GATHER_CASES = [((40, 56), 19, 19, 33), ((3, 40, 56), 12, 7, 33), ((40, 56), 27, 14, 17),
                ((2, 23, 31), 5, 2, 7)]


def _gather_inputs(shape, size, pad, n):
    rng = np.random.default_rng(n + size)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    h, w = shape[-2:]
    cx = rng.integers(-4, w + 2 * pad - size + 5, n)
    cy = rng.integers(-4, h + 2 * pad - size + 5, n)
    cx[:3] = [0, w + 2 * pad - size, -3]                       # the clamp limits
    cy[:3] = [h + 2 * pad - size, 0, h + 2 * pad]
    widths = ((0, 0),) * (len(shape) - 2) + ((pad, pad), (pad, pad))
    return img, cx, cy, np.pad(img, widths, mode="edge")


@pytest.mark.parametrize("shape,size,pad,n", GATHER_CASES)
def test_gather_plain_matches_pallas_kernel(shape, size, pad, n):
    img, cx, cy, padded = _gather_inputs(shape, size, pad, n)
    got = gather.gather_windows_plain(torch.as_tensor(img), torch.as_tensor(cx),
                                      torch.as_tensor(cy), size, pad)
    hp, wp = padded.shape[-2:]
    corners = np.stack([np.clip(cx, 0, wp - size), np.clip(cy, 0, hp - size)], -1)
    ref = jgather_windows(jnp.asarray(padded), jnp.asarray(corners, jnp.int32), size,
                          interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,size,pad,n", GATHER_CASES)
def test_gather_plain_matches_reference_block_gather(shape, size, pad, n):
    """Against the JAX package's CPU path (vmap of dynamic_slice, which
    clamps the corners itself), through the port's ops/image routing.  The
    callers never pass a negative corner (dynamic_slice would wrap it)."""
    img, cx, cy, padded = _gather_inputs(shape, size, pad, n)
    cx, cy = np.maximum(cx, 0), np.maximum(cy, 0)
    got = timg._gather_blocks(torch.as_tensor(img), torch.as_tensor(cx), torch.as_tensor(cy),
                              size, pad)
    ref = jimg._gather_blocks(jnp.asarray(padded), jnp.asarray(cx, jnp.int32),
                              jnp.asarray(cy, jnp.int32), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _bow_inputs(n, v, seed):
    """Random packed words with forced ties (duplicated words, descriptors
    on them exactly) and some invalid descriptors."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (v, 8), dtype=np.uint32)
    words[v // 2:v // 2 + 8] = words[1:9]
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    desc[:6] = words[2:8]
    valid = rng.uniform(size=n) > 0.2
    return words, desc, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_bow_tf_plain_matches_pallas_kernel(seed):
    words, desc, valid = _bow_inputs(64, 512, seed)          # the kernel needs V % 512 == 0
    words_pm1 = torb.unpack_pm1(torch.as_tensor(words.view(np.int32)))
    got = bowassign.bow_tf_plain(torch.as_tensor(desc.view(np.int32))[None],
                                 torch.as_tensor(valid)[None],
                                 torch.as_tensor(words.view(np.int32)))
    ref = bow_tf_pallas(jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(words_pm1.numpy()),
                        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref).astype(np.int32))
    assert int(got.sum()) == int(valid.sum())


def test_vocabulary_packs_its_words():
    words, _, _ = _bow_inputs(8, 96, 3)
    vocab = tbow.Vocabulary(torb.unpack_pm1(torch.as_tensor(words.view(np.int32))),
                            torch.ones(96))
    np.testing.assert_array_equal(vocab.words_packed.numpy(), words.view(np.int32))


def test_transform_rows_matches_reference_bow_rows():
    rng = np.random.default_rng(5)
    K, F, V = 12, 64, 256
    words, _, _ = _bow_inputs(8, V, 5)
    words_pm1 = torb.unpack_pm1(torch.as_tensor(words.view(np.int32)))
    idf = rng.uniform(0.1, 3.0, V).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (K, F, 8), dtype=np.uint32)
    desc[:, :4] = words[None, 1:5]
    kpv = rng.uniform(size=(K, F)) > 0.15
    kpv[3] = False                                            # a keyframe without features
    rows = np.asarray([0, 2, 3, 5, 7, 8, 9, 11], np.int32)
    row_valid = np.asarray([1, 1, 1, 1, 1, 1, 0, 1], bool)
    db = jlc._bow_rows(jnp.zeros((K, V), jnp.float32), jnp.asarray(words_pm1.numpy()),
                       jnp.asarray(idf), jnp.asarray(desc), jnp.asarray(kpv),
                       jnp.asarray(rows), jnp.asarray(row_valid))
    vocab = tbow.Vocabulary(words_pm1, torch.as_tensor(idf))
    got = tbow.transform_rows(vocab, torch.as_tensor(desc.view(np.int32))[rows],
                              torch.as_tensor(kpv)[rows])
    np.testing.assert_allclose(got.numpy()[row_valid], np.asarray(db)[rows[row_valid]],
                               atol=1e-6, rtol=0)
    one = tbow.transform(vocab, torch.as_tensor(desc.view(np.int32))[5],
                         torch.as_tensor(kpv)[5])
    np.testing.assert_array_equal(one.numpy(), got.numpy()[3])


def test_vocabulary_words_i8_and_save_load(tmp_path):
    """words_i8 is the ±1 words as int8 in unpack_pm1's order (the bowassign
    kernel's operand), equal to the wrapper's own unpacking, and a saved
    vocabulary loads back with the same words_packed and words_i8."""
    words, _, _ = _bow_inputs(8, 300, 4)
    packed = torch.as_tensor(words.view(np.int32))
    vocab = tbow.Vocabulary(torb.unpack_pm1(packed), torch.linspace(0.5, 2.0, 300))
    assert vocab.words_i8.dtype == torch.int8 and vocab.words_i8.is_contiguous()
    assert torch.equal(vocab.words_i8, torb.unpack_pm1(packed).to(torch.int8))
    path = str(tmp_path / "vocab.npz")
    tbow.save(path, vocab)
    back = tbow.load(path, device="cpu")
    for name in ("words_pm1", "idf", "words_packed", "words_i8"):
        assert torch.equal(getattr(back, name), getattr(vocab, name))


def _epilogue_argmax(sim):
    """A numpy model of csrc/bowassign.cu's epilogue over one block's rows:
    V tiles of 128 words; in each, warp wn (of 4 along the words) and lane
    tig (of 4 sharing a row) see words wn·32 + ni·8 + tig·2 + j (ni < 4,
    j < 2) in that order and keep the first maximum by strict >; then lanes
    merge by xor-shuffles 1 and 2 and the warps in order 0..3, each merge
    taking (higher similarity, then lower word index)."""
    rows, V = sim.shape
    best = np.full((rows, 4, 4), np.iinfo(np.int32).min, np.int64)
    arg = np.full((rows, 4, 4), np.iinfo(np.int32).max, np.int64)
    for t in range(-(-V // 128)):
        for wn in range(4):
            for tig in range(4):
                for ni in range(4):
                    for j in range(2):
                        col = t * 128 + wn * 32 + ni * 8 + tig * 2 + j
                        if col < V:
                            upd = sim[:, col] > best[:, wn, tig]
                            best[upd, wn, tig] = sim[upd, col]
                            arg[upd, wn, tig] = col

    def better(s, a, bs, ba):
        return (s > bs) | ((s == bs) & (a < ba))

    for off in (1, 2):
        perm = [t ^ off for t in range(4)]
        ob, oa = best[:, :, perm], arg[:, :, perm]
        u = better(ob, oa, best, arg)
        best, arg = np.where(u, ob, best), np.where(u, oa, arg)
    bs, ba = best[:, 0, 0], arg[:, 0, 0]
    for wn in range(1, 4):
        u = better(best[:, wn, 0], arg[:, wn, 0], bs, ba)
        bs, ba = np.where(u, best[:, wn, 0], bs), np.where(u, arg[:, wn, 0], ba)
    return ba


@pytest.mark.parametrize("v", [1000, 300, 128, 8192])
def test_bowassign_epilogue_order_gives_first_argmax(v):
    """The kernel's merge order picks torch.argmax's first index among
    ties: on ±1 products with duplicated words (so tied maxima) and on
    small-integer similarities with many ties, V a multiple of the 128-word
    tile and not."""
    rng = np.random.default_rng(v)
    words, desc, _ = _bow_inputs(64, v, v)
    words[v - 8:] = words[:8]                                 # ties across tiles
    sim = (torb.unpack_pm1(torch.as_tensor(desc.view(np.int32)))
           @ torb.unpack_pm1(torch.as_tensor(words.view(np.int32))).T).to(torch.int64)
    small = torch.as_tensor(rng.integers(-2, 3, (64, v)))
    for s in (sim, small):
        want = torch.argmax(s, dim=1).numpy()
        np.testing.assert_array_equal(_epilogue_argmax(s.numpy()), want)
        assert (s.numpy()[np.arange(64), want] == s.numpy().max(1)).all()


def test_transform_rows_matches_reference_transform_at_8192_words():
    """LoopConfig(vocab_words=8192): the JAX package's transform takes any
    V, and so does the port (no limit from the kernel on the card)."""
    from flvis_tpu.loop import bow as jbow

    V, N = 8192, 40
    words, desc, valid = _bow_inputs(N, V, 6)
    words_pm1 = torb.unpack_pm1(torch.as_tensor(words.view(np.int32)))
    idf = np.random.default_rng(6).uniform(0.1, 3.0, V).astype(np.float32)
    ref = jbow.transform(jbow.Vocabulary(jnp.asarray(words_pm1.numpy()), jnp.asarray(idf)),
                         jnp.asarray(desc), jnp.asarray(valid))
    vocab = tbow.Vocabulary(words_pm1, torch.as_tensor(idf))
    got = tbow.transform(vocab, torch.as_tensor(desc.view(np.int32)), torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    tf = bowassign.bow_tf_plain(torch.as_tensor(desc.view(np.int32))[None],
                                torch.as_tensor(valid)[None], vocab.words_packed)
    assert int(tf.sum()) == int(valid.sum()) and tuple(tf.shape) == (1, V)
