"""The port's spans and counters (`vegs_torch.utils.trace`) and the
benchmark's metrics that read them (`bench_h100/spans.py`,
`bench_h100/metrics/`).

  * off (no profiler session): `span` is one shared null context, nothing
    is recorded and `count` counts nothing;
  * under a CPU profiler session, one toy static step and one toy frame at
    the benchmark's toy sizes (`bench_h100/tests/toy.py`): the units, their
    spans' nesting and parents, and the sync spans at the sync sites the
    step and the frame pass;
  * `host_sync` counts the sync debug mode's warnings while a unit is
    open, inside a sync span or not, and shows every other warning;
  * `align` on a synthetic device timeline (stages back to back behind the
    host, launch-bound gaps, syncs, a clock offset and a drift between
    units), and each new metric's arithmetic on it: busy ms clipped to the
    spans, idle inside sync spans, the syncs a unit; None where the trace
    holds no device operation, an operation crosses a unit's edge, or the
    program has no trace module;
  * the box path, on one toy step and one toy frame with the dynamic
    configuration's 8 vehicles: `boxes.compose` inside `render.arrays`,
    `boxes.update` inside `train.update`, `boxes.instances` the boxes
    composed in one pass (one `boxes.compose` span); a static step and
    frame enter neither span; the box
    metrics' arithmetic on the synthetic timeline;
  * on the card (`gpu`): every synchronizing call of one step and one
    frame is counted, and lies inside a sync span.
"""

import json
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100 import inputs as inp, loops, program, run, spans
from bench_h100.align import align
from bench_h100.profile import Trace
from bench_h100.tests.toy import toy_cell
from vegs_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11

# the sync spans (`sync=True`): copies from pageable memory, reads to the
# host, `nonzero` and boolean masks' indexes, and the targets' copies
# through their staging buffers, each of which waits for its buffer's
# previous copy
SYNC_SPANS = {"targets.copy", "camera.copy", "sh_mask.copy", "bin.nonzero",
              "bin.mask", "ssim.copy", "densify.copy", "train.read"}

STEP_TREE = [
    ("train.step", None),
    ("train.targets", "train.step"), ("targets.copy", "train.targets"),
    ("targets.copy", "train.targets"), ("targets.normal", "train.targets"),
    ("camera.copy", "train.targets"),
    ("train.boxes", "train.step"),
    ("render.arrays", "train.step"), ("sh_mask.copy", "render.arrays"),
    ("raster.project", "train.step"),
    ("raster.bin", "train.step"), ("bin.nonzero", "raster.bin"),
    ("bin.mask", "raster.bin"), ("raster.project", "train.step"),
    ("raster.satcount", "train.step"),
    ("raster.bin", "train.step")] + [("bin.mask", "raster.bin")] * 8 + [
    ("raster.gather", "train.step"), ("raster.blend", "train.step"),
    ("train.loss", "train.step"), ("ssim.copy", "train.loss"),
    ("train.backward", "train.step"),
    ("train.update", "train.step"), ("densify.copy", "train.update"),
    ("train.read", "train.step"), ("train.kcap", "train.step"),
    ("train.densify", "train.step")]

FRAME_TREE = [
    ("video.frame", None),
    ("render.arrays", "video.frame"), ("sh_mask.copy", "render.arrays"),
    ("camera.copy", "video.frame"),
    ("raster.project", "video.frame"),
    ("raster.bin", "video.frame"), ("bin.nonzero", "raster.bin"),
    ("bin.mask", "raster.bin"), ("raster.project", "video.frame"),
    ("raster.satcount", "video.frame"),
    ("raster.bin", "video.frame")] + [("bin.mask", "raster.bin")] * 3 + [
    ("raster.gather", "video.frame"), ("raster.blend", "video.frame")]


def toy_scene(dev, **sizes):
    """The toy static configuration's trainer (`sizes` override the toy's
    gaussians, height, width), one camera, a frame's view and the
    forward-only raster config."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.scene.cameras import make_camera_like_input_camera
    from vegs_torch.train import Trainer

    cfg = dict(toy_cell("static-train")["config"], **sizes)
    program.build_kernels(dev)
    field = program.make_field(inp.synthetic_field(cfg, SEED, dev))
    scene = program.make_scene(cfg, inp.street_poses(cfg), field, dev)
    cams = scene.getTrainCameras()
    rng = np.random.default_rng(0)
    for c, nm in zip(cams, inp.normal_maps(cfg, SEED, len(cams), dev)):
        c.normal = nm.cpu().numpy()
        c.image = rng.random((3, cfg["height"], cfg["width"]),
                             dtype=np.float32)
    cap = 1 << (17 if cfg["gaussians"] <= 3000 else 23)
    rcfg = program.raster_config(cfg, k_cap=cap, k_pad=cap)
    trainer = Trainer(VegsConfig(), scene, raster_cfg=rcfg, device=dev)
    view = make_camera_like_input_camera(cams[0], add_zrot_val=60.0,
                                         add_xrot_val=0.0, add_tz=0.0)
    return trainer, cams[1], view, rcfg._replace(forward_only=True)


def toy_box_scene(dev, **sizes):
    """As `toy_scene`, of the toy dynamic configuration (`sizes` override
    the toy's gaussians, height, width, box_points): its 8 vehicles in the
    scene and the trainer, and the poses of the frame's vehicles last."""
    from vegs_torch.config import VegsConfig
    from vegs_torch.scene.cameras import make_camera_like_input_camera
    from vegs_torch.train import Trainer

    cfg = dict(toy_cell("dynamic-train")["config"], **sizes)
    program.build_kernels(dev)
    field = program.make_field(inp.synthetic_field(cfg, SEED, dev))
    box_fields, box_poses = loops._boxes(cfg, SEED, dev)
    scene = program.make_scene(cfg, inp.street_poses(cfg), field, dev,
                               box_fields, box_poses)
    cams = scene.getTrainCameras()
    rng = np.random.default_rng(0)
    for c, nm in zip(cams, inp.normal_maps(cfg, SEED, len(cams), dev)):
        c.normal = nm.cpu().numpy()
        c.image = rng.random((3, cfg["height"], cfg["width"]),
                             dtype=np.float32)
    cap = 1 << (18 if cfg["gaussians"] <= 3000 else 24)
    rcfg = program.raster_config(cfg, k_cap=cap, k_pad=cap)
    trainer = Trainer(VegsConfig(), scene, raster_cfg=rcfg, device=dev)
    view = make_camera_like_input_camera(cams[0], add_zrot_val=0.0,
                                         add_xrot_val=0.0, add_tz=0.0)
    return (trainer, cams[1], view, rcfg._replace(forward_only=True),
            box_poses[cams[0].frame])


def step_and_frame(trainer, cam, view, fcfg, boxes=None, it=3066):
    from vegs_torch import render_video

    m = trainer.train_iteration(it, camera=cam)
    with torch.inference_mode():
        out = render_video._render_view(trainer.scene, view, boxes or {},
                                        fcfg, trainer.bg)
    return m, out


@pytest.fixture(scope="module")
def toy_units():
    torch.set_num_threads(2)
    trace.reset()
    args = toy_scene(torch.device("cpu"))
    step_and_frame(*args)  # off: nothing recorded
    assert trace.recorded() == []
    with profile(activities=[ProfilerActivity.CPU]):
        m, out = step_and_frame(*args)
    assert m["num_dropped"] == 0 and int(out.num_dropped) == 0
    units = trace.recorded()
    trace.reset()
    return units


@pytest.fixture(scope="module")
def toy_box_units():
    torch.set_num_threads(2)
    trace.reset()
    args = toy_box_scene(torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        m, out = step_and_frame(*args)
    assert m["num_dropped"] == 0 and int(out.num_dropped) == 0
    units = trace.recorded()
    trace.reset()
    return units


def tree(unit):
    return [(s.name, None if s.parent is None else unit.spans[s.parent].name)
            for s in unit.spans]


def test_off_is_the_shared_null_context():
    trace.reset()
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("train.step"), trace.span("raster.bin", sync=True)
    assert a is b is trace._NULL
    with trace.span("train.step"):
        trace.count("host_sync", 5)
        with trace.span("bin.nonzero", sync=True):
            pass
    assert trace.recorded() == []


def test_toy_step_and_frame_nest(toy_units):
    step, frame = toy_units
    assert [u.index for u in toy_units] == [0, 1]
    assert tree(step) == STEP_TREE
    assert tree(frame) == FRAME_TREE
    for u in toy_units:
        for s in u.spans:
            assert s.host_start_ns <= s.host_end_ns
            if s.parent is not None:
                p = u.spans[s.parent]
                assert p.host_start_ns <= s.host_start_ns
                assert s.host_end_ns <= p.host_end_ns
            assert s.start_us is None  # no CUDA: no device times


def test_toy_host_syncs(toy_units):
    """The sync spans sit at the sync sites; on the CPU nothing syncs. The
    step rotates its camera's normal map on the device
    (`targets.normal_device`)."""
    for u in toy_units:
        assert [s.name for s in u.spans if s.sync] == [
            s.name for s in u.spans if s.name in SYNC_SPANS]
    assert toy_units[0].counts == {"targets.normal_device": 1}
    assert toy_units[1].counts == {}
    assert sum(s.sync for s in toy_units[0].spans) == 2 + 1 + 1 + 1 + 9 + 3
    assert sum(s.sync for s in toy_units[1].spans) == 1 + 1 + 1 + 4


BOX_SPANS = ("boxes.compose", "boxes.update")


def test_box_spans_nest(toy_box_units):
    """One `boxes.compose` a unit, inside `render.arrays`, holding one SH
    mask copy for all the box fields; one `boxes.update` a step, inside
    `train.update`; the vehicles' matrices copied in `boxes.copy`."""
    step, frame = toy_box_units
    for u, update in ((step, ["train.update"]), (frame, [])):
        t = tree(u)
        assert [p for n, p in t if n == "boxes.compose"] == ["render.arrays"]
        assert [p for n, p in t if n == "boxes.update"] == update
        assert [n for n, p in t if p == "boxes.compose"] == ["sh_mask.copy"]
        assert sum(n == "boxes.copy" for n, _ in t) == 1
        assert [s.name for s in u.spans if s.sync] == [
            s.name for s in u.spans if s.name in SYNC_SPANS | {"boxes.copy"}]
    assert ("boxes.copy", "video.frame") in tree(frame)
    assert ("boxes.copy", "train.boxes") in tree(step)


def test_box_instances_count_the_boxes(toy_box_units):
    """All 8 boxes of a unit are composed in one pass: one `boxes.compose`
    span for the 8 that `boxes.instances` counts."""
    step, frame = toy_box_units
    assert step.counts == {"targets.normal_device": 1, "boxes.instances": 8}
    assert frame.counts == {"boxes.instances": 8}
    for u in toy_box_units:
        assert sum(s.name == "boxes.compose" for s in u.spans) == 1


def test_static_units_enter_no_box_span(toy_units):
    for u in toy_units:
        assert not {s.name for s in u.spans} & set(BOX_SPANS)
        assert "boxes.instances" not in u.counts


def test_sync_warnings_are_counted():
    """While a unit is open each of the sync debug mode's warnings counts
    once, and once more under the innermost span where no sync span is
    open; other warnings are shown, and the filters are restored."""
    trace.reset()
    before = (list(warnings.filters), warnings.showwarning)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("video.frame"):
            with trace.span("raster.bin"):
                with trace.span("bin.nonzero", sync=True):
                    with trace.span("inner"):
                        warnings.warn(trace.SYNC_WARNING + " (at a site)")
                warnings.warn(trace.SYNC_WARNING)
                with pytest.warns(UserWarning, match="another"):
                    warnings.warn("another warning")
            warnings.warn(trace.SYNC_WARNING)
        with pytest.warns(UserWarning, match="called a synchronizing"):
            warnings.warn(trace.SYNC_WARNING)  # outside a unit: shown
    assert (list(warnings.filters), warnings.showwarning) == before
    (unit,) = trace.recorded()
    assert unit.counts == {"host_sync": 3,
                           "host_sync.unspanned.raster.bin": 1,
                           "host_sync.unspanned.video.frame": 1}
    trace.reset()


def test_spans_outside_a_unit_and_the_unit_cap():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("raster.bin", sync=True):  # outside a unit
            trace.count("host_sync")
        for _ in range(trace.MAX_UNITS + 3):
            with trace.span("video.frame"):
                trace.count("frames", 2)
    units = trace.recorded()
    assert len(units) == trace.MAX_UNITS
    assert [u.index for u in units] == list(range(3, trace.MAX_UNITS + 3))
    assert all(u.counts == {"frames": 2} for u in units)
    assert len(trace.recorded(units=4)) == 4
    trace.reset()
    assert trace.recorded() == []


# -- a synthetic device timeline ------------------------------------------

OFFSET = 7_654_321.25   # the trace's clock against unit 0's opening
DRIFT = 0.8             # microseconds a unit, trace against events


class Timeline:
    """A synthetic device timeline of `n` training steps, built as the card
    runs one: spans' edges are timing events, which run as the host records
    them where the device is idle and right behind the queued operations
    where the host is ahead. Each step: 35 us until its first operation; a
    targets stage whose copy syncs (the host wakes 12 us after it ends and
    launches 40 us later); the projection, binning (with a `nonzero` sync
    inside), the gather and the backward back to back behind the host, of
    operations 3-40 us long, 1 us apart; a read at the end. The loop runs
    3 ms between steps. Device times of the units from unit 0's opening;
    the operations on a clock OFFSET later, DRIFT more each unit, running
    `rate` faster."""

    def __init__(self, n=3, seed=3, rate=0.0, gap=3000.0):
        self.rate = rate
        rng = np.random.default_rng(seed)
        self.units, self.ops, self.busy = [], [], {}
        t = 0.0
        for k in range(n):
            self.shift = OFFSET + DRIFT * k
            self.spans = []
            self.stage = None
            self.last = t
            u = self.open("train.step", None, t)
            t += 35.0
            s = self.open("train.targets", u, t - 1.0)
            c = self.open("targets.copy", s, t - 0.5, sync=True)
            t = self.op(t, 50.0, "Memcpy HtoD")
            self.close(c, t + 12.0)
            self.close(s, t + 13.0)
            t += 52.0
            s = self.open("raster.project", u, t - 2.0)
            t = self.dense(t, 12, rng)
            self.close(s, self.last + 0.5)
            s = self.open("raster.bin", u, self.last + 0.7)
            t = self.dense(t, 8, rng)
            c = self.open("bin.nonzero", s, self.last + 0.9, sync=True)
            t = self.op(self.last + 1.4, 2.0, "Memcpy DtoH")
            self.close(c, t + 10.0)
            t += 45.0
            t = self.dense(t, 5, rng)
            self.close(s, self.last + 0.5)
            for name, m in (("raster.gather", 6), ("train.backward", 15)):
                s = self.open(name, u, self.last + 0.7)
                t = self.dense(t, m, rng)
                self.close(s, self.last + 0.5)
            s = self.open("train.read", u, self.last + 0.7, sync=True)
            t = self.op(self.last + 1.2, 1.0, "Memcpy DtoH")
            self.close(s, t + 9.0)
            self.close(u, t + 10.0)
            self.units.append(trace.Unit(k, [
                trace.Span(nm, p, y, 0, 0, a, b)
                for nm, p, y, a, b in self.spans],
                {"host_sync": 8}))
            t += 10.0 + gap
        self.busy = {k: v / 1e3 / n for k, v in self.busy.items()}

    def clock(self, t):
        """The trace's clock at device time t."""
        return t * (1 + self.rate) + self.shift

    def open(self, name, parent, at, sync=False):
        self.spans.append([name, parent, sync, at, None])
        if parent == 0:
            self.stage = name
        return len(self.spans) - 1

    def close(self, i, at):
        self.spans[i][4] = at

    def op(self, at, d, name="kernel"):
        self.ops.append((name, self.clock(at), self.clock(at + d)))
        self.busy[self.stage] = self.busy.get(self.stage, 0.0) + d
        self.last = at + d
        return at + d

    def dense(self, t, m, rng):
        """m operations behind the host, 1 us apart."""
        for _ in range(m):
            t = self.op(t, rng.uniform(3.0, 40.0)) + 1.0
        return t

    def sync_share(self, units, step=0.01) -> float:
        """The idle inside `units` (these units on the trace's clock)
        within EDGE_US of a sync span, in percent: counted here on a grid of
        `step` microseconds."""
        idle = in_sync = 0.0
        for u in units:
            t = np.arange(u.spans[0].start_us, u.spans[0].end_us, step)
            t += step / 2
            busy = np.zeros(t.shape, bool)
            for _, s, e in self.ops:
                busy |= (t >= s) & (t < e)
            near = np.zeros(t.shape, bool)
            for x in u.spans:
                if x.sync:
                    near |= ((t >= x.start_us - spans.EDGE_US)
                             & (t < x.end_us + spans.EDGE_US))
            idle += (~busy).sum() * step
            in_sync += (~busy & near).sum() * step
        return 100.0 * in_sync / idle


@pytest.mark.parametrize("lost, rate", [(0, 0.0), (30, 0.0), (0, 3e-4)])
def test_align_recovers_the_trace_clock(lost, rate):
    """Also where the trace lost its first `lost` operations (unit 0's
    stages up to its binning), and where its clock runs `rate` faster than
    the events' (300 ppm, as an H100 read, over steps 10 ms apart)."""
    tl = Timeline(n=4, rate=rate, gap=10_000.0)
    got = align(tl.units, sorted(tl.ops, key=lambda o: o[1])[lost:])
    for k, (u, g) in enumerate(zip(tl.units, got)):
        tl.shift = OFFSET + DRIFT * k
        for s, a in zip(u.spans, g.spans):
            # the events behind queued work run 0.5-0.9 us after it ends
            assert a.start_us == pytest.approx(tl.clock(s.start_us), abs=1.0)
            assert a.end_us == pytest.approx(tl.clock(s.end_us), abs=1.0)


def reading(monkeypatch, recs, ops):
    """A traced run's reading whose recorder holds `recs`."""
    monkeypatch.setattr(trace, "recorded", lambda units=None: recs[:units])
    return SimpleNamespace(trace=Trace(1.0, ops, []), units=len(recs))


def test_metrics_on_a_synthetic_trace(monkeypatch):
    tl = Timeline()
    r = reading(monkeypatch, tl.units, tl.ops)
    ms = pytest.approx
    for name, stage in (("project_ms.train", "raster.project"),
                        ("bin_ms.serve", "raster.bin"),
                        ("gather_ms.train", "raster.gather"),
                        ("backward_ms.train", "train.backward"),
                        ("targets_ms.train", "train.targets")):
        assert run.metric_reader(name)(r) == ms(tl.busy[stage], abs=2e-3)
    assert run.metric_reader("update_ms.train")(r) is None  # no such span
    assert run.metric_reader("host_syncs.train")(r) == 8
    share = run.metric_reader("sync_idle_share.serve")(r)
    assert share == ms(tl.sync_share(spans.units(r)), abs=0.05)
    assert 10 < share < 90
    table = spans.table(r)
    stages = [k for k in table if k not in ("unit", "in no stage")
              and "/" not in k]
    assert table["raster.bin/bin.nonzero"]["sync_idle_ms"] > 0
    for col in ("busy_ms", "idle_ms", "sync_idle_ms"):
        assert sum(table[k][col] for k in stages) + table["in no stage"][
            col] == ms(table["unit"][col])
    assert table["unit"]["busy_ms"] == ms(sum(tl.busy.values()), abs=1e-9)
    assert table["unit"]["sync_idle_ms"] == ms(
        table["unit"]["idle_ms"] * share / 100)
    assert spans.edges(r) == {"crossing_ops": 0, "stray_copies": 0,
                              "empty_sync_spans": 0, "outside_units_ms": 0.0,
                              "crossing": []}
    assert spans.counts(r) == {"host_sync": 8}


def test_a_failed_alignment_reads_none(monkeypatch):
    """Where the trace's clock and the events' disagree inside a unit (as
    an H100 read once, in a small host-paced scene), so that no offset
    fits: no span reading, while the count and the tool's table still
    read, and the check says why."""
    tl = Timeline()
    unit = tl.units[1].spans[0]
    jump = OFFSET + DRIFT + unit.start_us + 400.0  # 1 ms later from here
    ops = [(n, s + 1000.0 * (s > jump), e + 1000.0 * (s > jump))
           for n, s, e in tl.ops]
    r = reading(monkeypatch, tl.units, ops)
    for name in ("project_ms.train", "bin_ms.serve", "sync_idle_share.train",
                 "targets_ms.train"):
        assert run.metric_reader(name)(r) is None
    assert run.metric_reader("host_syncs.train")(r) == 8
    check = spans.edges(r)
    assert sum(check[k] for k in ("crossing_ops", "stray_copies",
                                  "empty_sync_spans")) >= 1
    assert spans.table(r)["unit"]["busy_ms"] > 0


def test_busy_clipped_to_the_span():
    busy = spans.Busy([("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0)])
    assert busy.spans == [[0.0, 20.0], [30.0, 40.0]]
    assert busy.within(15.0, 35.0) == 10.0
    assert busy.within(-5.0, 100.0) == 30.0
    assert busy.within(21.0, 29.0) == 0.0
    assert busy.gaps(15.0, 50.0) == [(20.0, 30.0), (40.0, 50.0)]
    assert busy.gaps(-3.0, 2.0) == [(-3.0, 0.0)]


NEW = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())
       ["per_layer"] if m["name"].split(".")[0] in
       {n.split(".")[0] for n in spans.NEW}]


@pytest.mark.parametrize("name", NEW)
def test_none_without_device_operations(name, monkeypatch):
    tl = Timeline(1)
    r = reading(monkeypatch, tl.units, [])
    assert run.metric_reader(name)(r) is None
    # a program without the trace module (the parent of this change)
    r = reading(monkeypatch, tl.units, tl.ops)
    monkeypatch.setitem(sys.modules, "vegs_torch.utils.trace", None)
    monkeypatch.delattr("vegs_torch.utils.trace")
    assert run.metric_reader(name)(r) is None


def test_new_metrics_are_the_benchmarks():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in bench["per_layer"]}
    assert len(NEW) == 13
    for name in NEW:
        m = got[name]
        kind = "train" if name.endswith(".train") else "serve"
        assert m["workloads"] == {"train": ["static-train"],
                                  "serve": ["static-serve", "dynamic-serve"]}[kind]
        assert m["better"] == "lower"
        assert m["moves"] == {"train": "train_steps_per_s",
                              "serve": "serve_frames_per_s"}[kind]


BOX_METRICS = ["box_compose_ms.serve", "box_idle_ms.serve"]


def box_timeline(instances=8):
    """The synthetic timeline with its gather spans renamed `boxes.compose`,
    its backward spans `boxes.update`, and `instances` boxes counted."""
    tl = Timeline()
    names = {"raster.gather": "boxes.compose", "train.backward": "boxes.update"}
    counts = {"host_sync": 8, "boxes.instances": instances}
    tl.units = [u._replace(spans=[x._replace(name=names.get(x.name, x.name))
                                  for x in u.spans],
                           counts={k: v for k, v in counts.items() if v})
                for u in tl.units]
    return tl


def test_box_metrics_on_a_synthetic_trace(monkeypatch):
    """Busy ms inside `boxes.compose`; idle ms inside the union of the box
    spans (here the two stages' idle); None where no unit counted
    `boxes.instances`, where the trace holds no device operation, or where
    the program has no trace module."""
    tl = box_timeline()
    r = reading(monkeypatch, tl.units, tl.ops)
    ms = pytest.approx
    table = spans.table(r)
    for part in ("train", "serve"):
        assert run.metric_reader(f"box_compose_ms.{part}")(r) == ms(
            tl.busy["raster.gather"], abs=2e-3)
        assert run.metric_reader(f"box_idle_ms.{part}")(r) == ms(
            table["boxes.compose"]["idle_ms"] + table["boxes.update"]["idle_ms"])
    assert table["boxes.update"]["idle_ms"] > 0
    for name in BOX_METRICS:
        tl = box_timeline(instances=0)
        assert run.metric_reader(name)(reading(monkeypatch, tl.units,
                                               tl.ops)) is None
        tl = box_timeline()
        assert run.metric_reader(name)(reading(monkeypatch, tl.units,
                                               [])) is None


@pytest.mark.parametrize("name", BOX_METRICS)
def test_box_metrics_are_the_benchmarks(name, monkeypatch):
    """Each box metric lists its dynamic cell alone and moves its rate;
    without the trace module it reads None."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {x["name"]: x for x in bench["per_layer"]}[name]
    kind = name.rsplit(".", 1)[1]
    assert m["workloads"] == [f"dynamic-{kind}"] and m["unit"] == "ms"
    assert m["moves"] == {"train": "train_steps_per_s",
                          "serve": "serve_frames_per_s"}[kind]
    tl = box_timeline()
    r = reading(monkeypatch, tl.units, tl.ops)
    monkeypatch.setitem(sys.modules, "vegs_torch.utils.trace", None)
    monkeypatch.delattr("vegs_torch.utils.trace")
    assert run.metric_reader(name)(r) is None


@pytest.mark.gpu
def test_host_sync_count_is_complete():
    """Every synchronizing call of one static step and one frame is
    counted, and lies inside a sync span: untraced, CUDA's sync debug mode
    warns of as many calls as `host_sync` counts in the same step and frame
    traced, and no count falls outside a sync span (at 200,000 Gaussians
    and the cells' 376x1408, where binning takes its compact path). The
    cells' counts: `python -m bench_h100.spans`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bench_h100.profile import record

    dev = torch.device("cuda")
    args = toy_scene(dev, gaussians=200_000, height=376, width=1408)
    step_and_frame(*args, it=3065)  # warm
    torch.cuda.synchronize()
    trace.reset()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step_and_frame(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = [x for x in w if str(x.message).startswith(trace.SYNC_WARNING)]
    assert trace.recorded() == []
    record(lambda: step_and_frame(*args), dev)
    units = trace.recorded()
    assert [u.spans[0].name for u in units] == ["train.step", "video.frame"]
    assert all(u.counts["host_sync"] for u in units)
    assert units[0].counts["targets.normal_device"] == 1
    assert [sorted(u.counts) for u in units] == [
        ["host_sync", "targets.normal_device"], ["host_sync"]]
    assert len(warned) == sum(u.counts["host_sync"] for u in units)
    assert all(s.start_us is not None for u in units for s in u.spans)
    assert torch.cuda.get_sync_debug_mode() == 0
    trace.reset()
