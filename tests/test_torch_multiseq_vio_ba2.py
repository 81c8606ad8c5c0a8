"""The checks of tests/test_torch_multiseq.py on the north-star composition:
the VIO path with the window BA every second frame (ba_every=2,
pipelined), with sequence 1 rolled horizontally by 7 px (bench.py:411-418)
so that the two sequences differ: each must match the reference's run of
its own frames, which it cannot if the port mixes up the sequences' states,
windows, corrections or loop nodes.  The same scene, draws and tolerances,
imported from there; pytest collects the imported test functions here,
where they take this module's `runs`."""

import numpy as np
import pytest

from test_torch_multiseq import (S, _pairs, build_runs, check_return_lag,  # noqa: F401
                                 scene, test_closures_match, test_drift_matches,
                                 test_loop_corrected_centres_match, test_trajectories_match)

ROLL = 7


@pytest.fixture(scope="module")
def runs(scene):  # noqa: F811
    return build_runs("vio", 2, scene, roll=ROLL)


def test_rolled_sequence_differs_and_return_lag(runs):
    """Sequence 1 sees other frames than sequence 0, so its trajectory
    differs, in the reference as in the port; both sequences close loops,
    and the pipelined run returns every chunk one chunk late."""
    jms, tms, rets = runs
    for ms in (jms, tms):
        t0 = np.asarray([t for (_, _, _, t) in ms.trajectories[0]])
        t1 = np.asarray([t for (_, _, _, t) in ms.trajectories[1]])
        assert not np.array_equal(t0, t1)
        assert all(len(_pairs(lc)) >= 1 for lc in ms.loopers[:S])
    check_return_lag(tms, rets)
