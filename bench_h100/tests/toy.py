"""A cell cut to a size the CPU runs in seconds: the same traffic, limits
and code, a small field and image. The cells of BENCHMARK.json, and the
dynamic configuration's two, whose cells are not in it yet (PERF.md)."""

import json
from pathlib import Path

import torch

from bench_h100 import run

ROOT = Path(__file__).resolve().parents[2]
# cells the harness drives that BENCHMARK.json does not hold: a
# configuration under the traffic and metrics of a cell it holds
EXTRA = {"dynamic-train": ("kitti360-dynamic-8veh", "static-train"),
         "dynamic-serve": ("kitti360-dynamic-8veh", "static-serve")}


def cell_spec(name: str) -> dict:
    if name not in EXTRA:
        return run.load_cell(name, root=ROOT)
    config, twin = EXTRA[name]
    spec = run.load_cell(twin, root=ROOT)
    path = ROOT / "bench_h100" / "configs" / f"{config}.json"
    return dict(spec, config=json.loads(path.read_text()))


def toy_cell(name: str, gaussians: int = 3000) -> dict:
    spec = cell_spec(name)
    spec["config"].update(gaussians=gaussians, height=64, width=256, frames=3)
    if spec["config"].get("vehicles"):
        spec["config"]["box_points"] = 300
    tr = spec["traffic"]
    spec["config"]["probe_cap"] = 1 << 20
    if tr["kind"] == "train":
        tr.update(warmup_steps=4, trace_units=2, trace_host_units=1)
    else:
        tr.update(warmup_frames=2, trace_units=2, trace_host_units=1)
    return spec


def run_toy(name: str, seed: int = 20260, control: bool = False,
            seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    return run.run_cell(toy_cell(name), seed, seconds, False,
                        torch.device("cpu"), control=control)
