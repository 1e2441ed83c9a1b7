"""The port's spans (``raytpu_torch/utils/spans.py``) and the per-lane
sweeps' work counters (``_build.work_counts``), on the CPU.

Outside a profiler a span is one shared no-op and a frame records
nothing; under ``torch.profiler`` a frame's spans nest from ``rt.step``
down to the culling prepass, the sharded path's too (on its slot threads),
and each counted host sync is one ``rt.sync``. A frame rendered with
``stats`` adds the plain walk's node visits and triangle tests to the work
counts; one without ``stats`` adds nothing.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytpu_torch import _build, integrator, scenes
from raytpu_torch.ops import perlane
from raytpu_torch.render import Renderer
from raytpu_torch.utils import spans
from tests.torch_twin import one_thread

CHAIN = ("rt.step", "rt.render", "rt.loop", "rt.bounce", "rt.sweep.closest",
         "rt.prepass")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def renderer():
    """A per-lane frame with mirror, diffuse and refractive hits, so both
    sweeps run."""
    with one_thread():
        r = Renderer(scenes.mixed_scene(64, 48, traversal="perlane"), "cpu")
        r.step(0.1)
    return r


def _spans(prof) -> list:
    """(name, start, end, thread) of the profile's ``rt.*`` spans."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("rt.")]


def _inside(child, parent) -> bool:
    return (child[3] == parent[3] and parent[1] <= child[1]
            and child[2] <= parent[2])


def test_a_span_outside_a_profiler_is_the_shared_noop(renderer, monkeypatch):
    assert spans.span("rt.step") is spans.span("rt.sync")

    def refuse(name):
        raise AssertionError(f"span {name} recorded with no profiler running")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    renderer.step(0.2)


def test_a_frame_nests_its_spans(renderer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        renderer.step(0.3)
    found = _spans(prof)
    names = {s[0] for s in found}
    assert set(CHAIN) <= names
    assert {"rt.set_transforms", "rt.readback", "rt.raygen", "rt.sky",
            "rt.detile", "rt.sweep.shadow", "rt.shade", "rt.accumulate",
            "rt.sync"} <= names
    for parent, child in zip(CHAIN, CHAIN[1:]):
        assert any(_inside(c, p) for c in found if c[0] == child
                   for p in found if p[0] == parent), (child, parent)
    sweeps = [s for s in found if s[0].startswith("rt.sweep.")]
    for c in (s for s in found if s[0] in ("rt.prepass", "rt.sweep.shadow")):
        parent = sweeps if c[0] == "rt.prepass" else [
            s for s in found if s[0] == "rt.bounce"]
        assert any(_inside(c, p) for p in parent), c
    loop = [s for s in found if s[0] == "rt.loop"]
    for name in ("rt.sky", "rt.raygen", "rt.detile"):
        assert not any(_inside(s, lp) for s in found if s[0] == name for lp in loop)


def test_one_sync_span_for_each_counted_sync(renderer):
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        renderer.render(stats=stats)
    syncs = sum(s[0] == "rt.sync" for s in _spans(prof))
    assert stats["host_syncs"] > 0 and syncs == stats["host_syncs"]


def test_the_sharded_frame_spans_its_slot_threads(renderer):
    r = Renderer(dataclasses.replace(renderer.scene,
                                     config=renderer.scene.config.replace(devices=2)),
                 "cpu")
    r.set_transforms(0.1)
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        r.step(0.1)
    found = _spans(prof)
    step = next(s for s in found if s[0] == "rt.step")
    bounces = [s for s in found if s[0] == "rt.bounce"]
    assert bounces and all(b[3] != step[3] for b in bounces)
    assert len({b[3] for b in bounces}) == 2


def test_a_frame_with_stats_counts_the_plain_walks_work(renderer):
    mine = {"perlane_closest_sweep": {}, "perlane_anyhit_sweep": {}}

    def closest(ts, rays, tmin, state):
        return perlane.perlane_closest_sweep_ref(
            ts, rays, tmin, state, counts=mine["perlane_closest_sweep"])

    def anyhit(ts, rays, tmin, tmax, occ, order="light"):
        return perlane.perlane_anyhit_sweep_ref(
            ts, rays, tmin, tmax, occ, order, counts=mine["perlane_anyhit_sweep"])

    _build.reset_work_counts()
    renderer.render()
    assert _build.work_counts() == {k: dict.fromkeys(keys, 0)
                                    for k, keys in _build.WORK_KEYS.items()}
    with integrator.kernels(perlane_closest=closest, perlane_anyhit=anyhit):
        renderer.render(stats={})
    got = _build.work_counts()
    _build.reset_work_counts()
    for k in mine:
        assert 0 < mine[k]["fetches"] <= mine[k]["nodes"] and mine[k]["tests"] > 0
        assert got[k] == {key: mine[k][key] for key in _build.WORK_KEYS[k]}
    renderer.render(stats={})
    assert _build.work_counts() == got
    _build.reset_work_counts()
