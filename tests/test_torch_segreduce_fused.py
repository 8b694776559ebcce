"""The payload gather's backward of the port (`segreduce.gather_expand_bwd`,
whose CUDA kernel is K3) against the VJP of the JAX package's
`gather_expand` (vegs_tpu/ops/rasterize.py), on the CPU.

Synthetic binning maps cover what the kernel must handle: empty segments,
one segment far longer than the warp's threshold, dead raw rows (order ==
k_pad), raw rows past the last segment, and cotangents on slots that no
live row reads. The cotangents are integers (plus, in the first segment,
1 + 2^-7 + 2^-8, exact in float32), so every sum is exact and the plain
version must equal JAX to the bit, in both aux dtypes; the aux half is
rounded once to nearest even (that first sum, a bf16 tie, rounds up to
1 + 2^-6 where truncation would give 1 + 2^-7). The outputs are row-major
and contiguous, as the kernel writes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vegs_tpu.ops.rasterize import gather_expand as jgather
from vegs_torch.ops import segreduce
from vegs_torch.ops.rasterize import GatherExpand

N = 500           # Gaussians (the dummy row N gets an empty segment)
K_PAD = 4096      # padded slots
LONG = 300        # rows of the one long segment
TIE = (1.0, 2.0 ** -7, 2.0 ** -8)  # f32 sum 1 + 3 * 2^-8: a bf16 tie


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _maps(seed=0):
    """(gidx [K_PAD], order [kr], ends [N + 1]) of a synthetic binning:
    Gaussian g owns raw rows [ends[g-1], ends[g]); each live row points at
    its own padded slot, whose gidx is g; a share of rows is dead."""
    rng = np.random.default_rng(seed)
    span = rng.poisson(1.5, N) * (rng.random(N) > 0.3)
    span[0] = len(TIE)
    span[7] = LONG
    ends = np.concatenate([np.cumsum(span), [span.sum()]]).astype(np.int32)
    rows = int(ends[-1])
    # rows past the last segment; JAX's blocked cumsum takes 512-row blocks
    kr = -(-(rows + 40) // 512) * 512
    slots = rng.permutation(K_PAD)[:kr].astype(np.int32)
    dead = rng.random(kr) < 0.2
    dead[:len(TIE)] = False
    order = np.where(dead, K_PAD, slots).astype(np.int32)
    gidx = np.full(K_PAD, N, np.int32)
    owner = np.searchsorted(ends, np.arange(rows), side="right")
    live = ~dead[:rows]
    gidx[slots[:rows][live]] = owner[live]
    return gidx, order, ends


def _cotangents(order, aux, seed=1):
    """[K_PAD, 8] f32 and [K_PAD, 16] cotangents (JAX layout): integers
    everywhere, the first segment's slots TIE in channel 0 of both."""
    rng = np.random.default_rng(seed)
    d_pf = rng.integers(-4, 5, (K_PAD, 8)).astype(np.float32)
    d_pa = rng.integers(-4, 5, (K_PAD, 16)).astype(np.float32)
    for r, v in enumerate(TIE):
        d_pf[order[r], 0] = v
        d_pa[order[r], 0] = v
    return d_pf, d_pa.astype(np.float32 if aux == "f32" else jnp.bfloat16)


@pytest.mark.parametrize("aux", ["f32", "bf16"])
def test_gather_expand_bwd_plain_equals_jax_vjp(aux):
    gidx, order, ends = _maps()
    d_pf, d_pa = _cotangents(order, aux)
    jdt = jnp.float32 if aux == "f32" else jnp.bfloat16
    pf = jnp.zeros((N + 1, 8), jnp.float32)
    pa = jnp.zeros((N + 1, 16), jdt)
    _, vjp = jax.vjp(lambda a, b: jgather(a, b, gidx, order, ends), pf, pa)
    want_f, want_a = vjp((jnp.asarray(d_pf), jnp.asarray(d_pa, jdt)))
    tdt = torch.float32 if aux == "f32" else torch.bfloat16
    t_pa = torch.from_numpy(np.asarray(jnp.asarray(d_pa, jnp.float32)).T.copy())
    args = (torch.from_numpy(d_pf.T.copy()), t_pa.to(tdt),
            torch.from_numpy(order), torch.from_numpy(ends))
    got_f, got_a = segreduce.gather_expand_bwd(*args)
    assert got_f.dtype == torch.float32 and got_a.dtype == tdt
    for got in (got_f, got_a):
        assert got.is_contiguous() and got.shape[0] == N + 1
        assert got.stride() == (got.shape[1], 1)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_a.float().numpy(),
                                  np.asarray(want_a, np.float32))
    # the pieces the maps were built to cover
    span = np.diff(ends, prepend=0)
    assert (span == 0).sum() > 50 and span.max() == LONG
    assert (order == K_PAD).sum() > 0 and len(order) > ends[-1]
    assert np.abs(got_f.numpy()[7]).sum() > 0
    # the tie: f32 sum exact, aux rounded once to nearest even
    tie = sum(TIE)
    assert got_f[0, 0].item() == tie
    want_tie = 1.0 + 2.0 ** -6 if aux == "bf16" else tie
    assert got_a[0, 0].item() == want_tie
    assert segreduce.gather_expand_bwd.launches == 0  # no kernel on the CPU


def test_gather_expand_backward_runs_the_fused_reduce():
    """`GatherExpand`'s backward is `gather_expand_bwd`: the same row-major
    gradients, contiguous, through autograd."""
    gidx, order, ends = _maps(seed=3)
    d_pf, d_pa = _cotangents(order, "bf16", seed=4)
    pf = torch.zeros((N + 1, 8), requires_grad=True)
    pa = torch.zeros((N + 1, 16), dtype=torch.bfloat16, requires_grad=True)
    t_pf = torch.from_numpy(d_pf.T.copy())
    t_pa = torch.from_numpy(np.asarray(d_pa, np.float32).T.copy()
                            ).to(torch.bfloat16)
    o, e = torch.from_numpy(order), torch.from_numpy(ends)
    x, y = GatherExpand.apply(pf, pa, torch.from_numpy(gidx), o, e)
    torch.autograd.backward((x, y), (t_pf, t_pa))
    want_f, want_a = segreduce.gather_expand_bwd(t_pf, t_pa, o, e)
    assert pf.grad.is_contiguous() and pa.grad.is_contiguous()
    assert torch.equal(pf.grad, want_f) and torch.equal(pa.grad, want_a)


def test_gather_expand_bwd_checks_and_span_stats():
    gidx, order, ends = _maps()
    d_pf = torch.zeros((8, K_PAD))
    d_pa = torch.zeros((16, K_PAD), dtype=torch.bfloat16)
    o, e = torch.from_numpy(order), torch.from_numpy(ends)
    with pytest.raises(ValueError, match="d_pa"):
        segreduce.gather_expand_bwd(d_pf, d_pa[:, :-1], o, e)
    with pytest.raises(ValueError, match="int32"):
        segreduce.gather_expand_bwd(d_pf, d_pa, o.long(), e)
    s = segreduce.span_stats(e)
    span = np.diff(ends, prepend=0)
    assert s["segments"] == N + 1 and s["max"] == LONG
    assert s["empty_share"] == pytest.approx((span == 0).mean())
    assert s["mean"] == pytest.approx(span.mean())
    assert s["longer_than"][32] == (span > 32).sum() == 1


@pytest.mark.parametrize("sat", [False, True], ids=["full", "sat_cull"])
def test_index_add_by_gidx_matches_plain(sat):
    """K3's library yardstick in chip_smoke.py -- autograd's own backward of
    `pay[gidx]`, an `index_add_` of the channel-major cotangents by gidx --
    equals the plain version to the bit on rows 0..n-1 of a real binning,
    with and without the sat cull (the dummy row n gathers the tail slots;
    the gather's backward gives it an empty segment)."""
    from tests.test_torch_rasterize_grad import _binned_both

    n, _, bt, _ = _binned_both(sat)
    k = bt.gidx.shape[0]
    rng = np.random.default_rng(3)
    d_pf = torch.from_numpy(rng.integers(-8, 8, (8, k)).astype(np.float32))
    d_pa = torch.from_numpy(rng.integers(-8, 8, (16, k)).astype(np.float32))
    ends = torch.cat([bt.gauss_ends, bt.gauss_ends[-1:]])
    want_f, want_a = segreduce.gather_expand_bwd(d_pf, d_pa, bt.order, ends)
    lib_f = torch.zeros(8, n + 1).index_add_(1, bt.gidx, d_pf)
    lib_a = torch.zeros(16, n + 1).index_add_(1, bt.gidx, d_pa)
    assert torch.equal(lib_f[:, :n].T, want_f[:n])
    assert torch.equal(lib_a[:, :n].T, want_a[:n])
