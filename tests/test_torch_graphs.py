"""The CUDA graph plans of the fused bounce loop (``raytpu_torch/graphs.py``)
on the CPU, where no graph can be captured:

* the schedule (``integrator.loop_ops``), which the eager loop runs,
  keeps the loop's rules for its wave steps, shadow choices and host
  reads on waves of many shapes, and ``graphs.plan_units`` lists every
  unit and read it yields;
* CPU frames, frames with ``stats``, work counting, validation, swapped
  kernel wrappers, ray chunks, unfolded samples and sharded frames take the
  eager path and never touch ``torch.cuda``'s graphs;
* a ``FramePlan`` whose "graphs" re-run the captured units renders the
  eager frame bit for bit with the eager frame's host reads: the plan's
  units, buffers and order, without the card;
* ``FramePlans`` keeps one plan a shape, least recently used dropped
  first, and captures anew for a scene with other tables;
* the benchmark's ``loop.graph_pct`` counts replay and eager-bounce events.

The card tests (``test_torch_cuda.py``) replay real graphs."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import torch

from raytpu_torch import _build, graphs, integrator, scenes
from raytpu_torch.integrator import RenderStatic
from raytpu_torch.render import Renderer
from tests.torch_twin import one_thread

# (P, RenderStatic fields): no budget, split or not; one rung; two and
# three rungs at the cells' shapes (reference, config3, config4); spp 1;
# no bounce; one rung by choice; full width with a budget
SHAPES = [
    (64, dict(samples_per_pixel=4, max_bounce_count=3)),
    (64, dict(samples_per_pixel=4, max_bounce_count=63)),
    (128, dict(samples_per_pixel=4, max_bounce_count=3)),
    (1024, dict(samples_per_pixel=4, max_bounce_count=63)),
    (2048, dict(samples_per_pixel=4, max_bounce_count=63)),
    (3840, dict(samples_per_pixel=4, max_bounce_count=3)),
    (8192, dict(samples_per_pixel=4, max_bounce_count=3)),
    (1024, dict(samples_per_pixel=1, max_bounce_count=3)),
    (1024, dict(samples_per_pixel=4, max_bounce_count=0)),
    (1024, dict(samples_per_pixel=4, max_bounce_count=63, ladder="off")),
    (2048, dict(samples_per_pixel=4, max_bounce_count=5, wavefront="full")),
]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _eager_schedule(p: int, rs, seed: int, monkeypatch) -> list:
    """The eager loop's (``integrator._trace_sample_fused``) waves, shadow
    choices and host reads on a wave of ``p`` packets of 2 lanes, its
    shading swapped for a seeded draw: each wave step kills each live
    packet with chance 0.3 and, in half the waves, lights a lane with
    chance 0.2."""
    gen = torch.Generator().manual_seed(seed)
    out = []

    def shade_wave(ts, rs_, rays, win, miss, stats, primary):
        out.append(("wave", rays.storage_offset() // rays.shape[2],
                    rays.shape[1], primary))
        live = win > 0.0
        lit = (torch.rand(win.shape, generator=gen) < 0.2) & live
        lit &= bool(torch.rand((), generator=gen) < 0.5)
        keep = torch.rand((win.shape[0], 1), generator=gen) >= 0.3
        return None, None, None, lit.int(), None, win * keep, None

    def light_wave(ts, rs_, shaded, win, tmp, decay_p, stats, primary, shadow):
        out.append(("shadow", shadow))
        win.copy_(shaded[5])

    read = integrator._read

    def spy(x, stats):
        value = read(x, stats)
        out.append(("read", value))
        return value

    monkeypatch.setattr(integrator, "_shade_wave", shade_wave)
    monkeypatch.setattr(integrator, "_light_wave", light_wave)
    monkeypatch.setattr(integrator, "_read", spy)
    integrator._trace_sample_fused(None, rs, torch.zeros((6, p, 2)),
                                   torch.zeros(p),
                                   torch.ones((p, 2), dtype=torch.bool), {})
    monkeypatch.undo()
    return out


def _check_rules(p: int, rs, record: list) -> None:
    """The fused loop's rules on one record of :func:`_eager_schedule`:
    without a budget a bounce at full width while ``any(window)`` reads
    true; with one the peeled full-width bounce, then per iteration an
    ``n_eff`` read and waves of the first rung (of those left) whose next
    rung ``n_eff`` exceeds, covering ``[0, n_eff)``; at most
    ``max_bounce_count`` bounces after the first; after each wave its
    ``any(lit)`` read and a shadow sweep as it read where the skip rule
    applies, else always a shadow sweep."""
    split = not integrator._shadow_always(rs)
    rec = iter(record)

    def wave(s, b, primary):
        assert next(rec) == ("wave", s, b, primary)
        if split:
            kind, lit = next(rec)
            assert kind == "read" and next(rec) == ("shadow", bool(lit))
        else:
            assert next(rec) == ("shadow", True)

    budget = integrator._loop_budget(p, rs)
    if not budget:
        for j in range(rs.max_bounce_count + 1):
            kind, live = next(rec)
            assert kind == "read"
            if not live:
                break
            wave(0, p, j == 0)
    else:
        wave(0, p, True)
        rungs = [*integrator._loop_rungs(p, budget, rs), 0]
        i, last = 0, p
        for _ in range(rs.max_bounce_count):
            kind, ne = next(rec)
            assert kind == "read" and 0 <= ne <= last
            last = ne
            if not ne:
                break
            while ne <= rungs[i + 1]:
                i += 1
            for s in range(0, ne, rungs[i]):
                wave(s, rungs[i], False)
    assert next(rec, None) is None


@pytest.mark.parametrize("p,fields", SHAPES)
def test_the_planner_yields_the_eager_loops_schedule(p, fields, monkeypatch):
    """The eager loop runs ``integrator.loop_ops``'s schedule; on seeded
    draws of the shading it keeps the loop's rules (:func:`_check_rules`),
    and ``graphs.plan_units`` lists, once, every unit and read a plan
    replays on that schedule."""
    rs = RenderStatic(width=64, height=64, **fields)
    units = graphs.plan_units(p, rs)
    assert len(set(units)) == len(units)
    split = not integrator._shadow_always(rs)
    seen = set()

    def run(op):   # a plan's units: graphs.FramePlan._run
        if not split or op[0] not in ("step", "iter"):
            return seen.add(op)
        for wave in integrator._op_waves(op):
            lit = next(values)
            seen.update({("shade", *wave), ("read", "lit", *wave),
                         ("light", *wave, bool(lit))})

    for seed in range(12):
        eager = _eager_schedule(p, rs, seed, monkeypatch)
        _check_rules(p, rs, eager)
        values = iter([e[1] for e in eager if e[0] == "read"])
        integrator.drive(integrator.loop_ops(p, rs), run,
                         lambda op: seen.add(op) or next(values))
    assert seen <= set(units), seen - set(units)
    assert any(op[0] == "read" for op in seen) == bool(rs.max_bounce_count)
    assert split == any(op[0] == "light" for op in seen)
    if split and rs.max_bounce_count:
        assert {op[4] for op in seen if op[0] == "light"} == {False, True}


def test_the_planner_keys_of_the_cells():
    """The units of the benchmark's shapes: config3 (3,840 packets, rungs
    960 and 192), config4 (8,192: 2,048, 512, 128), reference (2,048 with
    an any(lit) read a wave: rungs 512 and 128)."""
    def rs(bounces):
        return RenderStatic(width=64, height=64, samples_per_pixel=4,
                            max_bounce_count=bounces)

    iters = [u for u in graphs.plan_units(3840, rs(3)) if u[0] == "iter"]
    assert iters == [("iter", 960, n) for n in range(1, 5)] + [("iter", 192, 1)]
    iters = [u for u in graphs.plan_units(8192, rs(3)) if u[0] == "iter"]
    assert iters == [("iter", 2048, n) for n in range(1, 5)] + [
        ("iter", 512, 1), ("iter", 128, 1)]
    units = graphs.plan_units(2048, rs(63))
    assert units[:7] == [("begin",), ("shade", 0, 2048, True),
                         ("read", "lit", 0, 2048, True),
                         ("light", 0, 2048, True, False),
                         ("light", 0, 2048, True, True),
                         ("sort",), ("read", "neff")]
    shades = [u[1:3] for u in units if u[0] == "shade"][1:]
    assert shades == [(s, 512) for s in range(0, 2048, 512)] + [(0, 128)]
    assert len(units) == 7 + 5 * 4 + 1 and units[-1] == ("end",)


def _cuda_named(ts):
    """``ts`` with its device field saying CUDA: what ``graphable`` reads."""
    return dataclasses.replace(ts, device=torch.device("cuda"))


@pytest.fixture(scope="module")
def small():
    """A CPU renderer of a per-lane frame with every material."""
    with one_thread():
        r = Renderer(scenes.mixed_scene(64, 48, 2, 3, traversal="perlane"), "cpu")
        r.set_transforms(0.1)
    return r


@pytest.mark.parametrize("case", ["default", "cpu", "stats", "counting",
                                  "validation", "kernels", "chunks",
                                  "unfolded", "xla"])
def test_graphable_reads_what_the_code_can_observe(small, case):
    ts, rs, stats = _cuda_named(small.tscene), small.render_static, None
    with _build.counting(case == "counting"), integrator.kernels(
            **({"shade": integrator._PLAIN["shade"]} if case == "kernels" else {})):
        if case == "cpu":
            ts = small.tscene
        elif case == "stats":
            stats = {}
        elif case == "xla":
            ts = dataclasses.replace(ts, traversal="xla")
        else:
            rs = dataclasses.replace(rs, **{
                "validation": {"validation": True},
                "chunks": {"ray_chunk": 1024, "width": 1280},
                "unfolded": {"fold_spp": False}}.get(case, {}))
        assert graphs.graphable(ts, rs, stats) == (case == "default")
    assert graphs.graphable(_cuda_named(small.tscene), small.render_static)


def test_eager_frames_never_touch_cuda_graphs(small, monkeypatch):
    """CPU frames (plain and with stats, validation and counting) and a
    sharded frame render through the eager path; nothing reaches a
    graph."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was touched")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(graphs, "FramePlan", refuse)
    want = integrator.render_frame(small.tscene, small.render_static,
                                   small.camera_tensor())
    assert torch.equal(small.render(), want)
    stats = {}
    assert torch.equal(small.render(stats=stats), want)
    assert stats["host_syncs"] > 0
    with _build.counting():
        small.render()
    scene = small.scene
    checked = Renderer(dataclasses.replace(
        scene, config=scene.config.replace(validation=True)), "cpu")
    checked.set_transforms(0.1)
    assert torch.equal(checked.render(), want)
    sharded = Renderer(dataclasses.replace(
        scene, config=scene.config.replace(devices=2)), "cpu")
    sharded.set_transforms(0.1)
    assert torch.equal(sharded.render(), want)


class _Rerun:
    """A stand-in for a CUDA graph on the CPU: capturing runs the unit once
    and keeps what it returned; a replay runs it again, copying a returned
    tensor into the kept one (a graph's output stays at its address)."""

    def __init__(self, thunk):
        self.thunk = thunk
        self.out = thunk()

    def replay(self):
        new = self.thunk()
        if isinstance(self.out, torch.Tensor):
            self.out.copy_(new)


def _rerun_capturer(device):
    def capture(thunk):
        g = _Rerun(thunk)
        return g, g.out
    return capture


@pytest.mark.parametrize("scene", ["perlane", "deep"])
def test_a_plan_renders_the_eager_frame(scene, monkeypatch):
    """A plan made at one pose and time renders, at others, the eager frame
    bit for bit with the eager frame's host reads and no capture: the
    per-lane tier on compacted waves (no any(lit) read), and a 63-bounce
    loop on compacted waves with an any(lit) read a wave."""
    monkeypatch.setattr(graphs, "capturer", _rerun_capturer)
    size = (32, 32, 4, 3) if scene == "perlane" else (96, 32, 2, 63)
    r = Renderer(scenes.mixed_scene(*size, traversal="perlane"), "cpu")
    r.set_transforms(0.1)
    plan = graphs.FramePlan(r.tscene, r.render_static, r.camera_tensor())
    want_units = [("raygen",), *graphs.plan_units(plan.p, r.render_static),
                  ("sky",)]
    assert list(plan.units) == want_units
    assert plan.fits(r.tscene)
    reads = []
    read = integrator._read
    monkeypatch.setattr(integrator, "_read",
                        lambda x, stats: reads.append(1) or read(x, stats))
    for tp, yaw in ((0.1, 0.0), (0.4, 20.0)):
        r.camera.process_mouse_movement(yaw, 0.0)
        r.set_transforms(tp)
        assert plan.fits(r.tscene)
        reads.clear()
        want = integrator.render_frame(r.tscene, r.render_static, r.camera_tensor())
        eager = len(reads)
        reads.clear()
        assert torch.equal(plan.render(r.tscene, r.camera_tensor()), want)
        assert len(reads) == eager > 0
    assert list(plan.units) == want_units
    moved = dataclasses.replace(r.tscene, entries=r.tscene.entries.clone())
    assert not plan.fits(moved)
    assert not plan.fits(dataclasses.replace(r.tscene, traversal="pallas"))


def test_frame_plans_keep_one_plan_a_shape(small, monkeypatch):
    """``FramePlans``: a shape's first frame renders eagerly and makes its
    plan, later frames replay it; a scene with new tables captures anew;
    beyond ``MAX_PLANS`` shapes the least recently used plan goes."""
    made, replayed = [], []

    class Plan:
        def __init__(self, ts, rs, camera):
            self.ts, self.rs = ts, rs
            made.append(rs.width)

        def fits(self, ts):
            return ts.entries is self.ts.entries

        def render(self, ts, camera):
            replayed.append(self.rs.width)
            return "replayed"

    monkeypatch.setattr(graphs, "FramePlan", Plan)
    monkeypatch.setattr(graphs, "graphable", lambda ts, rs, stats=None: stats is None)
    monkeypatch.setattr(integrator, "render_frame",
                        lambda ts, rs, camera, stats=None: "eager")
    plans = graphs.FramePlans()
    ts, cam = small.tscene, small.camera_tensor()

    def frame(width, scene=ts, stats=None):
        rs = dataclasses.replace(small.render_static, width=width)
        return plans.render(scene, rs, cam, stats)

    assert [frame(64), frame(64), frame(64, stats={})] == ["eager", "replayed", "eager"]
    other = dataclasses.replace(ts, entries=ts.entries.clone())
    assert [frame(64, other), frame(64, other)] == ["eager", "replayed"]
    for w in range(65, 65 + graphs.MAX_PLANS):
        frame(w)
    assert frame(65) == "replayed" and frame(64, other) == "eager"
    assert made == [64, 64, *range(65, 65 + graphs.MAX_PLANS), 64]
    assert replayed == [64, 64, 65]


def _reader():
    from rtbench import manifest

    path = Path(manifest.__file__).resolve().parent / "metrics" / "loop.graph_pct.py"
    return manifest.load_module(path, "metric reader").read


class _Ctx:
    def __init__(self, host):
        self.trace = type("Trace", (), {"_host": sorted(host)})()


def test_the_graph_share_counts_events():
    """100 x replays / (replays + rt.bounce events outside every capture),
    counting each event: replays nested in one span count twice; a bounce
    inside a capture counts as nothing; no event reads nothing."""
    read = _reader()
    host = [(0, 100, "rt.graph.capture", 1), (10, 20, "rt.bounce", 1),
            (200, 300, "rt.loop", 1), (210, 220, "rt.graph.replay", 1),
            (230, 240, "rt.graph.replay", 1), (250, 260, "rt.graph.replay", 1),
            (400, 410, "rt.bounce", 1), (400, 410, "rt.bounce", 1)]
    assert read(_Ctx(host)) == pytest.approx(60.0)
    assert read(_Ctx([h for h in host if h[2] != "rt.bounce"])) == 100.0
    assert read(_Ctx([h for h in host if h[2] != "rt.graph.replay"])) == 0.0
    assert read(_Ctx([(0, 10, "rt.loop", 1), (20, 30, "rt.graph.capture", 1),
                      (21, 22, "rt.bounce", 1)])) is None


def test_replays_count_their_captured_launches():
    """Launches captured into a graph are held, not counted; a replay
    counts them."""
    _build.reset_launch_counts()
    with _build.captured_launches() as held:
        assert held == {}
        with _build.captured_launches() as inner:
            pass
        assert inner == {} and _build._capture.launches is held
    assert getattr(_build._capture, "launches", None) is None
    _build.add_launches({"raygen": 1, "mega_closest_sweep": 3})
    _build.add_launches({"mega_closest_sweep": 2})
    counts = _build.launch_counts()
    assert counts["raygen"] == 1 and counts["mega_closest_sweep"] == 5
    _build.reset_launch_counts()
