"""The checks of tests/test_torch_multiseq.py on the VIO path
(MultiSeqSlam(use_imu=True).process_chunk_vio) with the window BA per
keyframe (ba_every=1): the same
scene, draws and tolerances, imported from there.  pytest collects the
imported test functions here, where they take this module's `runs`."""

import pytest

from test_torch_multiseq import (build_runs, scene, test_closures_match,  # noqa: F401
                                 test_drift_matches, test_loop_corrected_centres_match,
                                 test_sequences_agree_and_return_lag, test_trajectories_match)


@pytest.fixture(scope="module")
def runs(scene):  # noqa: F811
    return build_runs("vio", 1, scene)
