"""`python -m vegs_torch.train --data_parallel 2` on the CPU against the JAX
CLI's `--data_parallel 2`, on the toy KITTI-360 root of
tests/test_torch_loaders.py (4 frames of 48x64 stereo, one vehicle box;
--eval, 6 iterations of 2 cameras, densification off, no report).

The port's `main` starts 2 gloo ranks (`parallel.launch.spawn`); rank 0
reads the scene first and alone writes the PLYs, cfg_args.json and
metrics.jsonl. The multi-host way in (`--coordinator_address tcp://...
--num_processes 2 --process_id i`, `parallel.mesh.initialize_distributed`)
runs as two CPU processes started here, each with the intra-op threads a
spawned rank gets, on a localhost port found free (on another if rank 0
finds it taken); their PLYs are held against `--data_parallel 2`'s to
the bit (the same ranks' code in the same order). The JAX CLI runs its
shard_map step on 2 of the virtual CPU devices (tests/conftest.py).
Tolerance against JAX: every column of the final static and instance PLYs
within 1e-4, as the one-device CLI test (tests/test_torch_cli.py: float32
sums in another order through the normal init and six Adam steps).
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_cli import PLY_ATOL, _ply
from tests.test_torch_loaders import CAR, N_FRAMES, SEQ, START, \
    toy_kitti360_root
from vegs_torch import train as ttrain

ITERS = 6


def _argv(root, model_path, *extra):
    return ["--source_path", str(root), "--model_path", str(model_path),
            "--data_type", "kitti360", "--seq", SEQ,
            "--start_frame", str(START), "--end_frame", str(START + N_FRAMES),
            "--eval", "--iterations_override", str(ITERS),
            "--test_iterations", "100", "--densify_from_iter", "100",
            "--data_parallel", "2", "--k_cap", "8192", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vegs_tpu.train import main as jmain

    base = tmp_path_factory.mktemp("cli_dp")
    root = toy_kitti360_root(base / "root")
    cwd, stdout = os.getcwd(), sys.stdout
    os.environ.pop("VEGS_SD_CHECKPOINT", None)
    os.chdir(base)   # the readers' .cache/ goes here
    try:
        got = ttrain.main(_argv(root, base / "port"), device="cpu")
        sys.stdout = stdout
        jmain(_argv(root, base / "jax", "--backend", "dense"))
    finally:
        sys.stdout = stdout
        os.chdir(cwd)
    return got, base


def test_main_data_parallel_matches_jax(runs):
    got, base = runs
    assert got is None   # the ranks ran in their own processes
    rel = [Path("point_cloud") / f"iteration_{ITERS}" / "point_cloud.ply",
           Path(f"instance_{CAR}") / "point_cloud" / f"iteration_{ITERS}"
           / "point_cloud.ply"]
    for r in rel:
        p, j = _ply(base / "port" / r), _ply(base / "jax" / r)
        assert sorted(p) == sorted(j) and len(p["x"]) == len(j["x"])
        for col in j:
            np.testing.assert_allclose(p[col], j[col], rtol=0, atol=PLY_ATOL,
                                       err_msg=f"{r} {col}")


def test_main_data_parallel_writes_from_rank_zero_alone(runs):
    _, base = runs
    port = base / "port"
    assert (port / "cfg_args.json").exists()
    assert (port / "metrics.jsonl").exists()
    assert sorted(p.name for p in (port / "point_cloud").iterdir()) == \
        [f"iteration_{ITERS}"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the two processes take ~5 s alone, ~20 s beside the rest of the suite
# under `-n 6`, and ~200 s with the host's cores three times oversubscribed
TIMEOUT_S = 600


def _multi_host(base, model_path) -> list:
    """Rank 0 and rank 1 of `main` as two processes on a port found free
    -> [(return code, output)]; a process that fails stops the other."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    threads = max(1, (os.cpu_count() or 1) // 2)
    code = ("import sys, torch; torch.set_num_threads(int(sys.argv[1])); "
            "from vegs_torch.train import main; "
            "main(sys.argv[2:], device='cpu')")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    env.pop("VEGS_SD_CHECKPOINT", None)
    logs = [base / f"{model_path.name}.{i}.log" for i in range(2)]
    procs = []
    try:
        for i, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(threads),
                     *_argv(base / "root", model_path, "--coordinator_address",
                            addr, "--num_processes", "2", "--process_id",
                            str(i))],
                    cwd=base, env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TIMEOUT_S
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, log.read_text()) for p, log in zip(procs, logs)]


def test_main_multi_host_matches_data_parallel(runs):
    """Two processes, one rank each, meeting over TCP on localhost."""
    _, base = runs
    for attempt in range(3):
        # another process may bind the port between `_free_port` and rank
        # 0's bind: start again on another port
        model_path = base / f"multihost{attempt}"
        res = _multi_host(base, model_path)
        if not any(rc and "EADDRINUSE" in out for rc, out in res):
            break
    for i, (rc, out) in enumerate(res):
        assert rc == 0, f"process {i}:\n{out[-3000:]}"
    rel = [Path("point_cloud") / f"iteration_{ITERS}" / "point_cloud.ply",
           Path(f"instance_{CAR}") / "point_cloud" / f"iteration_{ITERS}"
           / "point_cloud.ply"]
    for r in rel:
        got, want = _ply(model_path / r), _ply(base / "port" / r)
        assert sorted(got) == sorted(want)
        for col in want:
            np.testing.assert_array_equal(got[col], want[col],
                                          err_msg=f"{r} {col}")
