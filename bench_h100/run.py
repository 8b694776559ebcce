"""One run of one cell of the port's benchmark on one card.

    python -m bench_h100.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding BENCHMARK.json. The cell names a
configuration (`bench_h100/configs/<config>.json`) and a traffic mix
(`bench_h100/traffic/<traffic>.json`, run by `loops`); each end-to-end
metric is read from the window by `bench_h100/end_to_end/<metric>.py`, each
per-layer metric from the trace by `bench_h100/metrics/<metric>.py` (or,
where there is no such file, by the file of the name without its last
`.part`: `metrics/ops_device_ms.py` reads `ops_device_ms.train` and
`ops_device_ms.serve`). A run sets up, measures
for `--seconds`, with `--trace 1` traces a few more steps or frames, runs
the plain reference (`check`), and prints one JSON line last on standard
output; the numbers compared, each beside its limit, are the last lines of
standard error. Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits non-zero.

`--control 1` runs no program: it prints the numbers of the reference
computed in the control's lower precision against the reference (the
readings that a limit must stay under).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vegs_tpu")
# the run's record beside the metrics: window, capacities, host times
RUN_KEYS = ("elapsed_s", "k_cap", "k_pad", "need_raw", "need_pad", "n",
            "step_ms", "densify_ms", "frame_ms", "leaves", "nonfinite")
# host threads of the one process (BLAS, OpenMP, torch's CPU ops): few, so
# that runs on a shared host spread less
THREADS = 2


def load_cell(name: str, root: Path = Path(".")) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    file and metric entries resolved by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    return {"cell": cell,
            "config": json.loads((root / config["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic"
                                   / f"{cell['traffic']}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reader(folder: str, name: str):
    """`read` of `<folder>/<name>.py`, or of the file of `name` without its
    last `.part` where the first is not there."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / folder / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_{folder}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_reader(name: str):
    """The per-layer metric `name`'s `read(reading)`."""
    return reader("metrics", name)


def end_to_end(res: dict, names) -> dict:
    """{name: value} of the end-to-end metrics `names` over the window
    (`res`, a traffic loop's result): host clock, the peak from the
    device's allocator."""
    return {name: reader("end_to_end", name)(res) for name in names}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, dev,
             control: bool = False) -> dict:
    """Drive the cell on `dev` and judge it; the result line's fields."""
    import torch

    from . import check, loops, work

    cfg, tr = spec["config"], spec["traffic"]
    kind = tr["kind"]
    if control:
        if kind == "train":
            ref = check.reference_train(cfg, tr, seed, dev)
            low = check.reference_train(cfg, tr, seed, dev, lowp=True)
            numbers = check.train_numbers(low, ref)
        else:
            frames = check_frames(cfg, tr, seed, dev)
            ref = check.reference_serve(cfg, tr, seed, frames, dev)
            low = check.reference_serve(cfg, tr, seed, frames, dev, lowp=True)
            numbers = check.serve_numbers(low["frames"], ref["frames"])
        ok, checks = check.verdict(numbers, tr["limits"])
        return {"correct": ok, "attempted": 0, "failed": 0, "metrics": {},
                "checks": checks}

    res = loops.KINDS[kind](cfg, tr, seed, seconds, trace, dev, T_START)
    t_ref = time.perf_counter()
    if kind == "train":
        ref = check.reference_train(cfg, tr, seed, dev)
        numbers = check.train_numbers(res["checked"], ref)
        res["leaves"] = check.leaf_table(res["checked"], ref)
        res["nonfinite"] = res["checked"]["nonfinite"]
    else:
        prog = res["checked"]["frames"]
        ref = check.reference_serve(cfg, tr, seed, sorted(prog), dev)
        numbers = check.serve_numbers(prog, ref["frames"])
    ok, checks = check.verdict(numbers, tr["limits"])
    out = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"],
           "peak": res["program_peak"],
           "run": {**{k: res[k] for k in RUN_KEYS if k in res},
                   "reference_s": time.perf_counter() - t_ref}}
    if torch.device(dev).type == "cuda":
        out["run"]["reference_peak"] = int(torch.cuda.max_memory_allocated())
    if not trace:
        e2e = end_to_end(res, [m["name"] for m in spec["end_to_end"]])
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in spec["end_to_end"] if e2e[m["name"]] is not None}
    else:
        from . import profile

        pairs = check.mean_pairs(ref["pairs"])
        # every Gaussian projected: the field's and the vehicles'
        n = res["n"] + cfg.get("vehicles", 0) * cfg.get("box_points", 0)
        reading = SimpleNamespace(
            kind=kind, trace=res["trace"], units=res["trace_units"],
            window_unit_s=res["elapsed_s"] / res["attempted"], n=n,
            pairs=pairs, pixels=cfg["height"] * cfg["width"],
            aux=cfg["aux_dtype"], work=work, kernel_of=profile.kernel_of)
        values = {}
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(reading)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = values
        tr_ = res["trace"]
        out["busy_s"], out["window_s"] = tr_.busy_s(), tr_.wall_s
        out["breakdown"] = profile.breakdown(tr_, res["host_trace"])
        out["run"]["pairs"] = pairs
    out["checks"] = checks
    return out


def check_frames(cfg, tr, seed, dev) -> list:
    from . import check, inputs

    traj, _ = check.serve_views(cfg, tr)
    n_aug = len(tr["augmentations"])
    return inputs.draw(seed, tr["checked_frames"], n_aug, len(traj) // n_aug, dev)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)

    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    chips = spec["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{chips}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": out.pop("peak", 0)}
    if args.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    checks = out.pop("checks")
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["run"] = out.get("run", {})
    line["checks"] = checks
    print(f"card: {card_line()}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def card_line() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


if __name__ == "__main__":
    sys.exit(main())
