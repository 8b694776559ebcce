"""The port's backward bisect (`vegs_torch.perf.stages.bwd_bisect`) against
the JAX package's perf/r03_bwd_bisect.py, on the CPU at 64x256 with 3,000
Gaussians and k_cap 2^14 (the script's H, W, N and K_CAP rewritten; its
scene is `refscale.build_scene`'s at that size).

The script's timer is replaced by one that calls each line once, with the
module's `jax.value_and_grad` wrapped (jitted) to keep the loss and the
gradients it returns; JAX's blend runs its Pallas kernels in interpret
mode, the port its plain versions of K1-K3. Each of the six lines' loss
and gradients against JAX's:

  * the loss within 1e-5 relative, or 2^-7 where it sums a bf16 table
    (the payload and the gathered payload: one bf16 rounding of the
    total apart);
  * each leaf's gradient within 1e-4 relative L2 (float32 through the
    projection, the payload's bf16 cast and the blend; the sums run in
    other orders), except the SH coefficients' through the blend's
    backward: their gradient reaches them only through the aux rows'
    cotangents, which each side's K2 rounds to bf16 once, so a value near
    a rounding boundary may land one bf16 step away; they are held within
    2^-8 relative L2, one bf16 step (this size reads ~3e-4).
"""

import jax
import numpy as np
import pytest
import torch

from tests.torch_jax_probes import ACC0, load
from vegs_torch.ops import binning
from vegs_torch.perf import refscale, stages

H, W, N, K_CAP = 64, 256, 3000, 1 << 14
LOSS_RTOL, BF16_LOSS_RTOL, GRAD_RTOL = 1e-5, 2.0 ** -7, 1e-4
BF16_GRAD_RTOL = 2.0 ** -8
SH_LEAF = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _KeepGrads:
    """Stands in for the script's `jax`: `value_and_grad` jitted, its
    results kept; everything else JAX's."""

    def __init__(self):
        self.got = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def value_and_grad(self, f, argnums=0):
        inner = jax.jit(jax.value_and_grad(f, argnums=argnums))

        def call(*args):
            out = inner(*args)
            self.got.append(out)
            return out
        return call


@pytest.fixture(scope="module")
def jax_lines(tmp_path_factory):
    mod = load("r03_bwd_bisect", tmp_path_factory.mktemp("jax_cache"),
               [("\nH, W = 376, 1408", f"\nH, W = {H}, {W}"),
                ("\nN = 500_000", f"\nN = {N}"),
                ("\nK_CAP = 1 << 21", f"\nK_CAP = {K_CAP}")])
    keep = _KeepGrads()
    mod.jax = keep
    got = {}

    def timeit(name, fn, args, iters=8):
        fn(args, ACC0)
        got[name.strip()] = keep.got[-1]
        return 0.0
    mod.timeit = timeit
    mod.main()
    return got


@pytest.fixture(scope="module")
def port_lines():
    cam, arrays = refscale.build_scene(N, H, W, "cpu")
    grid = binning.TileGrid.for_image(H, W)
    return stages.bwd_lines(cam, grid, K_CAP, arrays)


def test_the_lines_are_the_scripts(jax_lines, port_lines):
    assert list(port_lines) == list(jax_lines)


@pytest.mark.parametrize("name", list(stages.bwd_lines(
    None, None, 0, [torch.zeros(1)] * 5)))
def test_bwd_bisect_line_matches_jax(jax_lines, port_lines, name):
    jl, jg = jax_lines[name]
    loss, grads = port_lines[name]()
    rtol = (BF16_LOSS_RTOL if name.endswith(("payload", "gather"))
            else LOSS_RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=rtol)
    assert len(grads) == len(jg)
    for i, (g, j) in enumerate(zip(grads, jg)):
        j = np.asarray(j, np.float64)
        assert np.isfinite(g.numpy()).all()
        err = np.linalg.norm(g.double().numpy() - j) / np.linalg.norm(j)
        print(f"{name} leaf {i}: relative L2 {err:.2e}")
        lim = (BF16_GRAD_RTOL if i == SH_LEAF and name.endswith("blend")
               else GRAD_RTOL)
        assert err <= lim, (name, i, err)


def test_bwd_bisect_runs_on_the_cpu_with_finite_losses():
    lines = []
    res = stages.bwd_bisect(device="cpu", n=N, h=H, w=W, k_cap=K_CAP,
                            iters=1, warmup=0,
                            emit=lambda **kw: lines.append(kw))
    assert res["counts"]["dropped"] == 0 and res["counts"]["kept"] > 0
    assert len(res["lines"]) == 6
    assert all(ln["finite"] and "cpu_ms" in ln for ln in res["lines"].values())
