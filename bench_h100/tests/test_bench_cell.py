"""BENCHMARK.json's cells resolve to their files by name, and a new
configuration, traffic file or metric is found without editing any file."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_h100 import run
from bench_h100.tests.toy import ROOT

CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def test_benchmark_keys_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == CONTRACT_KEYS
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        spec = run.load_cell(w["name"], root=ROOT)
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["kind"] in ("train", "serve")
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        assert set(spec["traffic"]["limits"])
    for m in bench["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert callable(run.reader("end_to_end", m["name"]))


def test_metric_file_of_the_base_name():
    """`<name>.<part>` without a file of its own is read by `<name>.py`,
    and a file of its own comes first."""
    assert not (ROOT / "bench_h100/metrics/device_idle_share.train.py").exists()
    shared = run.metric_reader("device_idle_share")
    assert run.metric_reader("device_idle_share.train").__code__.co_code == \
        shared.__code__.co_code
    assert run.metric_reader("k1_roofline.serve").__module__.endswith(
        "k1_roofline.serve")


def test_added_by_files_alone(tmp_path, monkeypatch):
    """A cell, a configuration, a traffic file and a metric added as new
    files and new entries run through the same harness."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_h100", root / "bench_h100")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "other-config"
    (root / "bench_h100/configs/other-config.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "bench_h100/traffic/serve-trajectory.json").read_text())
    tr["augmentations"] = tr["augmentations"][:1]
    (root / "bench_h100/traffic/serve-forward.json").write_text(json.dumps(tr))
    (root / "bench_h100/metrics/new_metric.serve.py").write_text(
        "def read(r):\n    return 42.0\n")
    bench["configs"].append(dict(bench["configs"][0], name="other-config",
                                 file="bench_h100/configs/other-config.json"))
    bench["workloads"].append({"name": "other-serve", "config": "other-config",
                               "traffic": "serve-forward", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "new_metric.serve", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device: one H100",
                               "moves": "serve_frames_per_s",
                               "workloads": ["other-serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "HERE", root / "bench_h100")
    spec = run.load_cell("other-serve", root=root)
    assert spec["config"]["name"] == "other-config"
    assert len(spec["traffic"]["augmentations"]) == 1
    assert [m["name"] for m in spec["per_layer"]] == ["new_metric.serve"]
    assert run.metric_reader("new_metric.serve")(None) == 42.0


def test_no_card_exits_nonzero():
    """Without a CUDA device the command prints no result and fails."""
    p = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                        "static-serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_only_benchmark_files_exit_nonzero(tmp_path):
    """A directory holding BENCHMARK.json and the benchmark's files alone
    (no program) fails."""
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "bench_h100.run", "--workload",
                        "static-serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["static-train", "static-serve"])
def test_traced_toy_run(cell):
    """A traced run reads its per-layer metrics from the reading; on the
    CPU the trace holds no device operation, so only the whole step's or
    frame's share is there, and it lies in (0, 100]."""
    import torch

    from bench_h100.tests.toy import toy_cell

    torch.set_num_threads(2)
    spec = toy_cell(cell)
    out = run.run_cell(spec, 2 ** 31 + 5, 0.3, True, torch.device("cpu"))
    assert out["correct"], out["checks"]
    (name, m), = out["metrics"].items()
    assert name == {"train": "step_mfu.train",
                    "serve": "frame_mfu.serve"}[spec["traffic"]["kind"]]
    assert 0 < m["value"] <= 100
