"""The fused stereo step with the PnP rescue forced (min_inliers = 65, more
than the entry configuration's 64 slots can give, so every tracking frame
starves, runs the EPnP RANSAC rescue and its motion-BA polish, then fails
through the two-strike entry and re-initialises), against the reference's
_chunk_fused on the same configuration.  The rescued pose is dropped on a
failed frame, so the rescue shows in each frame's inlier count and mean
reprojection error, held here exactly and to 1e-4 px.  Helpers and the
other tolerances are those of tests/test_torch_fused_step.py.  One JAX
compile for the file."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.backend import window_ba as jwba
from flvis_tpu.frontend import tracker as jtr
from flvis_tpu.pipeline import runner as jrunner
from flvis_tpu_torch.backend import window_ba as twba
from flvis_tpu_torch.frontend import tracker as ttr
from flvis_tpu_torch.ops import pnp as tpnp
from flvis_tpu_torch.pipeline import runner as trunner
from test_torch_fused_step import (assert_chunks_match, cameras, configs, jax_draws,
                                   stereo_frames)

torch.set_num_threads(1)
MIN_INLIERS = 65


@pytest.fixture(scope="module")
def pnp_runs():
    jf, jb, tf, tb = configs(min_inliers=MIN_INLIERS)
    jc, tc = cameras(jf)
    imgs0, imgs1 = stereo_frames(blank=())
    _, jba, _, jys = jrunner._chunk_fused(jf, jb, jc, jtr.init_state(jf), jwba.empty(jb),
                                          jwba.null_correction(jb), jnp.asarray(imgs0),
                                          jnp.asarray(imgs1))
    draws = jax_draws(jf, np.asarray(jys[0].status))
    null = twba.null_correction(tb, device="cpu")
    step = functools.partial(trunner._fused_frame_step, tf, tb, tc, null)
    carry = (ttr.init_state(tf, device="cpu"), twba.empty(tb, device="cpu"), null)
    rescues = []
    real = tpnp.pnp_ransac
    mp = pytest.MonkeyPatch()
    mp.setattr(ttr.pnp_ops, "pnp_ransac", lambda *a, **kw: rescues.append(1) or real(*a, **kw))
    try:
        (_, tba, _), packed, _ = trunner.run_chunk_eager(
            step, carry, (torch.as_tensor(imgs0), torch.as_tensor(imgs1)), lambda i: draws[i])
    finally:
        mp.undo()
    return jys, jba, packed, tba, len(rescues)


def test_pnp_rescue_matches_chunk_fused(pnp_runs):
    jys, jba, packed, tba, n_rescues = pnp_runs
    st = packed[:, 2].numpy().astype(int)
    assert n_rescues >= 3 and (st == jtr.STATUS_FAIL).any()
    assert_chunks_match(jys, jba, packed, tba)
    np.testing.assert_allclose(packed[:, 4].numpy(), np.asarray(jys[0].mean_reproj_err),
                               atol=1e-4, rtol=0)
