"""flvis_tpu_torch.entry — the port's counterpart of __graft_entry__.py:

  - entry("cpu") hands back one track_frame at the small configuration's
    shapes (__graft_entry__._small_cfg), the same arguments the JAX
    entry() builds (its random images): both initialise on them, with the
    same status, image shapes and landmark slots, and the same detected
    keypoints (the first frame's draws are only its dummy depths);
  - dryrun_multichip(2, "cpu") runs the multi-device paths on 2 spawned
    gloo ranks — the sequence-sharded tracking step, the system and VIO
    chunks, MultiSeqSlam over the mesh, optimize_sharded,
    chunk_fused_sharded, the keyframe-sharded scores — as the JAX
    dryrun_multichip runs them on an n-device mesh; the ranks' replicated
    readings agree."""

import dataclasses

import numpy as np
import torch

from flvis_tpu_torch import entry

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry():
    import jax

    import __graft_entry__ as jentry

    jfn, jargs = jentry.entry()
    tfn, targs = entry.entry("cpu")
    assert {f.name: getattr(entry._small_cfg(), f.name)
            for f in dataclasses.fields(entry._small_cfg())} == \
        {f.name: getattr(jentry._small_cfg(), f.name)
         for f in dataclasses.fields(entry._small_cfg())}
    for a, b in zip(jargs[2:], targs[2:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jst, jout = jfn(*jargs)
    tst, tout = tfn(*targs)
    jax.block_until_ready(jst)
    assert int(tout.status) == int(jout.status)
    np.testing.assert_array_equal(tst.table.active.numpy(), np.asarray(jst.table.active))
    live = tst.table.active.numpy()
    np.testing.assert_allclose(tst.table.uv.numpy()[live], np.asarray(jst.table.uv)[live],
                               atol=1e-3)


def test_dryrun_multichip_on_two_cpu_ranks():
    ranks = entry.dryrun_multichip(2, "cpu", threads=1)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["track_status"] == [1] and r["multiseq_frames"] == 2
        assert r["multiseq_centers"] == (2, 3)
        assert np.isfinite(r["sharded_ba_cost"])
    a, b = ranks
    assert a["sharded_ba_cost"] == b["sharded_ba_cost"]
    assert a["chunk_status"] == b["chunk_status"] and a["best"] == b["best"]
