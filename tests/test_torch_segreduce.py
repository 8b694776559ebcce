"""Segment reduce of the port (vegs_torch/ops/segreduce.py) against
vegs_tpu: `segment_reduce_cols` on CPU tensors runs `segment_reduce_ref`,
the plain version of kernel K3, which must equal the JAX Pallas kernel
(interpret mode) EXACTLY on integer-valued columns (every partial sum is an
exact float32 integer, so the summation order cannot matter), with empty
segments, columns past the last segment, and at the TPU kernel's padded
shapes (C=24, K=4096, NG=1024)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vegs_tpu.ops import segreduce as jseg
from vegs_torch.ops import segreduce as tseg

C, K, NG = 24, 4096, 1024


def _segments(rng, ng, k_used):
    """Monotone [starts, ends) covering [0, k_used) with many empty ones."""
    lens = rng.poisson(2.0, ng) * (rng.random(ng) > 0.3)
    lens = np.floor(lens * k_used / max(lens.sum(), 1)).astype(np.int64)
    ends = np.cumsum(lens).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    return starts, ends


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_reduce_plain_matches_pallas_exactly(seed):
    rng = np.random.default_rng(seed)
    starts, ends = _segments(rng, NG, K - 300)
    assert (starts == ends).sum() > 100, "empty segments are exercised"
    assert ends[-1] < K, "columns past the last segment are exercised"
    cols = rng.integers(-50, 50, (C, K)).astype(np.float32)
    ref = np.asarray(jseg.segment_reduce_cols(
        jnp.asarray(cols), jnp.asarray(starts), jnp.asarray(ends),
        interpret=True))
    got = tseg.segment_reduce_cols(torch.from_numpy(cols),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(ends))
    assert got.dtype == torch.float32 and tuple(got.shape) == (C, NG)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the plain version needs none of the TPU shape constraints
    few = tseg.segment_reduce_ref(torch.from_numpy(cols[:5, :1000]),
                                  torch.from_numpy(starts[:37]),
                                  torch.from_numpy(np.minimum(ends[:37], 1000)))
    np.testing.assert_array_equal(few.numpy(), ref[:5, :37])


def test_segment_reduce_float_columns_and_checks():
    """Real-valued columns: the plain version sums each segment in column
    order in float32, so it equals a float64 reference to float32
    rounding (|d| <= 1e-6 * sum |x|)."""
    rng = np.random.default_rng(2)
    starts, ends = _segments(rng, 500, 2000)
    cols = rng.normal(size=(C, 2048)).astype(np.float32)
    got = tseg.segment_reduce_cols(torch.from_numpy(cols),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(ends)).numpy()
    for g in range(0, 500, 7):
        seg = cols[:, starts[g]:ends[g]].astype(np.float64)
        np.testing.assert_allclose(got[:, g], seg.sum(axis=1),
                                   atol=1e-6 * np.abs(seg).sum() + 1e-12)
    with pytest.raises(ValueError, match="float32"):
        tseg.segment_reduce_cols(torch.zeros((2, 4), dtype=torch.float64),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        tseg.segment_reduce_cols(torch.zeros((2, 4)),
                                 torch.zeros(1, dtype=torch.int64),
                                 torch.ones(1, dtype=torch.int64))
