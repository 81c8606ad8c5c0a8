"""vio/vimotion.imu_feed_batch_plain (the fused IMU kernel's oracle)
against flvis_tpu.vio.vimotion.imu_feed_batch on the CPU, over the packet
cases of tests/test_torch_cuda.py's card tests: a ring of 24 slots that the
packets wrap, and an init → steady switch mid-packet with masked rows.
On the CPU, imu_feed_batch takes the plain version and never the kernel.

Tolerance 1e-5 on every field, as tests/test_torch_vimotion.py: float32
rounding of the same arithmetic (sums over a packet, chained quaternion
products); integer and boolean fields and the raw ring rows are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flvis_tpu.config import VioConfig as JVioConfig
from flvis_tpu.vio import vimotion as jv
from flvis_tpu_torch.config import VioConfig
from flvis_tpu_torch.interop import to_numpy
from flvis_tpu_torch.ops.kernels import imu_chain
from flvis_tpu_torch.vio import vimotion as tv
from test_torch_cuda import imu_case

torch.set_num_threads(1)
TOL = 1e-5
EXACT = ("t", "acc", "gyro", "head", "count", "initialized", "init_count", "init_acc_sum",
         "init_gyro_sum")


@pytest.mark.parametrize("case", ["ring_wrap", "straddle"])
def test_plain_feed_matches_jax(case):
    kw, packets = imu_case(case)
    jcfg, tcfg = JVioConfig(**kw), VioConfig(**kw)
    js, ts = jv.init_state(jcfg), tv.init_state(tcfg, device="cpu")
    switched = False
    for acc, gyro, t, valid in packets:
        was = bool(ts.initialized)
        js = jv.imu_feed_batch(jcfg, js, jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(t),
                               None if valid is None else jnp.asarray(valid))
        ts = tv.imu_feed_batch_plain(tcfg, ts, torch.as_tensor(acc), torch.as_tensor(gyro),
                                     torch.as_tensor(t),
                                     None if valid is None else torch.as_tensor(valid))
        switched |= not was and bool(ts.initialized) and valid is not None
        jd, td = to_numpy(js), to_numpy(ts)
        for k in jd:
            got, ref = np.asarray(td[k], np.float64), np.asarray(jd[k], np.float64)
            if k in EXACT:
                np.testing.assert_array_equal(got, ref, err_msg=k)
            else:
                np.testing.assert_allclose(got, ref, atol=TOL, rtol=0, err_msg=k)
    assert switched                       # the init → steady switch fell in a masked packet
    if case == "ring_wrap":
        assert int(ts.count) == kw["imu_capacity"] and int(ts.head) != 0


def test_cpu_feed_launches_no_kernel():
    """On CPU tensors imu_feed_batch is the plain version: no launch counted."""
    kw, packets = imu_case("masked")
    cfg = VioConfig(**kw)
    st = tv.init_state(cfg, device="cpu")
    n0 = (imu_chain.imu_feed_kernel.launches, imu_chain.attitude_chain_kernel.launches)
    for acc, gyro, t, valid in packets:
        st = tv.imu_feed_batch(cfg, st, torch.as_tensor(acc), torch.as_tensor(gyro),
                               torch.as_tensor(t),
                               None if valid is None else torch.as_tensor(valid))
    assert bool(st.initialized)
    assert (imu_chain.imu_feed_kernel.launches,
            imu_chain.attitude_chain_kernel.launches) == n0


def test_feed_kernel_refuses_cpu_tensors():
    """The fused kernel's wrapper has no CPU fallback: CPU tensors raise."""
    cfg = VioConfig(imu_capacity=24)
    st = tv.init_state(cfg, device="cpu")
    acc, gyro, t, valid = imu_case("init_only")[1][0]
    with pytest.raises(ValueError, match="CUDA"):
        imu_chain.imu_feed_kernel(tuple(getattr(st, k) for k in imu_chain.FEED_FIELDS),
                                  torch.as_tensor(acc), torch.as_tensor(gyro),
                                  torch.as_tensor(t), valid, init_samples=cfg.init_samples,
                                  gravity=cfg.gravity, madgwick_beta=cfg.madgwick_beta)
