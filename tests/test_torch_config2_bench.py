"""The benchmark's config2 (``rtbench/configs/config2.json``: the static
mirror teapot stand-in, 5,120 triangles, 2 bounces) through the port's
normal path on the CPU, and what the consensus walk counts on the waves
past the first bounce:

* the port's ``Renderer``, built by ``rtbench.run.port_renderer`` at a size
  whose waves are whole blocks of 32x32 tiles, takes the consensus tier,
  and its frames at three poses of ``closeup_mirror`` match the plain
  reference at every pixel under ``limits/config2.closeup.json``, with
  most primary samples on the mirror;
* K8's and K9's later entries (``_build.work_counts``, ``.later``) hold
  the waves after the first bounce: a frame's entries are the first
  bounce's (the same frame at ``max_bounce_count`` 0) plus its later ones,
  key by key, the later own counts at most the walked ones, and a frame
  with no bounce after the first counts nothing there;
* ``rt.later`` encloses every unit of the loop past the first bounce and
  no other, in an eager frame and around a plan's replays;
* on the tiny bench (the teapot at depth 1), the spans above, a stats
  loop's later counts as ``consensus.later_useful_pct`` reads them, a
  correct run of config2.closeup, and the reference in bfloat16 in the
  program's place not correct.

No JAX: the port and the benchmark alone."""

from __future__ import annotations

import bisect
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytpu_torch import _build, graphs, integrator
from rtbench import camerapath, check, manifest, readings, run
from rtbench.reference import scene_math
from rtbench.reference.whitted import Reference
from rtbench.tests.conftest import make_tiny_bench
from tests.test_torch_graphs import _rerun_capturer
from tests.torch_twin import one_thread

BENCH = Path(run.__file__).resolve().parent
CELL = "config2.closeup"
SIZE = {"width": 64, "height": 32}     # 2 x 1 tiles x 4 spp: one block
SEED = 2**33 + 29
POSES = (0, 41, 87)
SWEEPS = ("mega_closest_sweep", "mega_anyhit_sweep")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def bench():
    """The cell's configuration at the test size with an 8-texel sky, its
    mesh, sky, poses and limits, and the port's Renderer of it."""
    cell = manifest.Cell(manifest.load(), CELL)
    cfg = dict(cell.config, **SIZE, skybox=dict(cell.config["skybox"], size=8))
    meshes = [run.make_mesh(BENCH, o["mesh"]) for o in cfg["objects"]]
    sky = run.make_sky(cfg, SEED, "cpu")
    poses, tps, _ = camerapath.make(cell.traffic, cfg, SEED)
    viewer = run.Viewer(run.port_renderer(cfg, meshes, sky, "cpu"))
    return cell, cfg, meshes, sky, poses, tps, viewer


def _at(viewer, poses, tps, k):
    viewer.pose(poses[k])
    viewer.renderer.set_transforms(tps[k])
    return viewer.renderer


@pytest.mark.parametrize("k", POSES)
def test_config2_closeup_frames_match_the_reference(bench, k):
    cell, cfg, meshes, sky, poses, tps, viewer = bench
    assert meshes[0][2].shape == (5120, 3)
    r = _at(viewer, poses, tps, k)
    stats = {}
    img = r.render(stats=stats).numpy()
    assert stats["tier"] == "mega"
    assert img.shape == (SIZE["height"], SIZE["width"], 3)

    ref = Reference(cfg, meshes, torch.as_tensor(sky), "cpu")
    ref.set_history([tps[k]])
    ys, xs = np.mgrid[:SIZE["height"], :SIZE["width"]]
    pixels = np.stack([xs.ravel(), ys.ravel()], axis=1)
    st = {}
    pose = poses[k]
    want = ref.render(scene_math.basis(pose["position"], pose["yaw"], pose["pitch"]),
                      pixels, st).numpy()
    assert 0.5 < st["primary_hit_share"] <= 1.0    # most samples hit the mirror
    gaps = check.gaps(img[pixels[:, 1], pixels[:, 0]], want)
    judged = check.judge(check.numbers([gaps], cell.limits["gap_threshold"]),
                         cell.limits["limits"])
    assert check.passed(judged), judged
    assert float(want.std()) > 0.02               # not a flat frame


@pytest.fixture(scope="module")
def counts(bench):
    """``_build.work_counts()`` of the frame at pose 41 rendered with
    ``stats`` at the configuration's 2 bounces and at none."""
    _, _, _, _, poses, tps, viewer = bench
    r = _at(viewer, poses, tps, 41)
    out = {}
    with one_thread():
        for bounces in (2, 0):
            rs = dataclasses.replace(r.render_static, max_bounce_count=bounces)
            _build.reset_work_counts()
            integrator.render_frame(r.tscene, rs, r.camera_tensor(), stats={})
            out[bounces] = _build.work_counts()
    _build.reset_work_counts()
    return out


@pytest.mark.parametrize("kernel", SWEEPS)
def test_the_later_entries_split_the_totals(counts, kernel):
    """Per kernel and key: the frame's total is its first bounce's (the
    frame without a bounce after it) plus its later waves'; the later
    waves' own counts are at most their walked ones."""
    keys = _build.WORK_KEYS[kernel]
    assert _build.WORK_KEYS[kernel + _build.LATER] == keys
    total, later = counts[2][kernel], counts[2][kernel + _build.LATER]
    first = counts[0][kernel]
    for key in keys:
        assert total[key] == first[key] + later[key], (key, total, first, later)
    assert later["own_nodes"] <= later["nodes"] and later["own_tests"] <= later["tests"]
    if kernel == "mega_closest_sweep":     # the reflected waves walk the tree
        assert 0 < later["own_nodes"] < later["nodes"]
        assert 0 < first["own_nodes"] < first["nodes"]
    else:                                  # no surface is diffuse: no lit lane
        assert sum(total.values()) == 0


def test_no_later_counts_without_a_bounce(counts):
    assert all(counts[0][k + _build.LATER] == dict.fromkeys(_build.WORK_KEYS[k], 0)
               for k in SWEEPS)
    assert sum(counts[0]["mega_closest_sweep"].values()) > 0


def _spans(prof, names) -> list:
    """(name, start, end) of the profile's spans named in ``names``, in
    order of start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda s: s[1])


def _in_later(found, span) -> bool:
    later = [s for s in found if s[0] == "rt.later"]
    i = bisect.bisect_right([s[1] for s in later], span[1]) - 1
    return i >= 0 and span[2] <= later[i][2]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The cell on the tiny bench (32x18, the teapot at depth 1)."""
    bench = make_tiny_bench(tmp_path_factory.mktemp("tiny2"))
    return manifest.Cell(manifest.load(bench.parent / "BENCHMARK.json"), CELL, bench)


@pytest.fixture(scope="module")
def tiny_viewer(tiny):
    """The tiny cell's viewer, its poses and time parameters."""
    cfg = tiny.config
    meshes = [run.make_mesh(tiny.bench_dir, o["mesh"]) for o in cfg["objects"]]
    sky = run.make_sky(cfg, SEED, "cpu", tiny.bench_dir)
    poses, tps, _ = camerapath.make(tiny.traffic, cfg, SEED, tiny.bench_dir)
    with one_thread():
        viewer = run.Viewer(run.port_renderer(cfg, meshes, sky, "cpu"))
    return viewer, poses, tps


def test_rt_later_encloses_the_bounces_after_the_first(tiny_viewer):
    """An eager frame: the first bounce lies in no ``rt.later`` span, every
    later bounce in one, and each ``rt.later`` holds a bounce."""
    viewer, poses, tps = tiny_viewer
    r = _at(viewer, poses, tps, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render()
    found = _spans(prof, ("rt.later", "rt.bounce"))
    bounces = [s for s in found if s[0] == "rt.bounce"]
    assert len(bounces) == 3                       # the first and 2 bounces
    assert [_in_later(found, b) for b in bounces] == [False, True, True]
    for s in found:
        if s[0] == "rt.later":
            assert any(s[1] <= b[1] and b[2] <= s[2] for b in bounces)


def test_a_plans_later_replays_lie_inside_rt_later(tiny_viewer, monkeypatch):
    """A plan's frame: each replay of a unit past the first bounce lies
    inside an ``rt.later`` span and every other replay outside one."""
    viewer, poses, tps = tiny_viewer
    monkeypatch.setattr(graphs, "capturer", _rerun_capturer)
    r = _at(viewer, poses, tps, 2)
    plan = graphs.FramePlan(r.tscene, r.render_static, r.camera_tensor())
    replayed = []
    replay = plan._replay
    monkeypatch.setattr(plan, "_replay", lambda op: replayed.append(op) or replay(op))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.render(r.tscene, r.camera_tensor())
    found = _spans(prof, ("rt.later", "rt.graph.replay"))
    replays = [s for s in found if s[0] == "rt.graph.replay"]
    assert len(replays) == len(replayed)
    inside = [_in_later(found, s) for s in replays]
    assert inside == [integrator.later_unit(op) for op in replayed]
    assert any(inside) and not all(inside)


def test_the_later_useful_share_reads_the_stats_loop(tiny_viewer):
    """``consensus.later_useful_pct`` over the work a stats loop of the tiny
    cell counts: the later entries' own operations over their walked
    ones."""
    from types import SimpleNamespace

    viewer, poses, tps = tiny_viewer
    _build.reset_work_counts()
    with one_thread():
        stats = run.stats_loop(viewer, poses, tps)
    read = manifest.load_reader(BENCH / "metrics" / "consensus.later_useful_pct.py")
    got = read(SimpleNamespace(stats=stats, trace=None, ops_per_s=0.0))
    later = _build.work_counts()["mega_closest_sweep" + _build.LATER]
    _build.reset_work_counts()
    own = later["own_nodes"] * 23 + later["own_tests"] * 51
    made = later["nodes"] * 23 + later["tests"] * 51
    assert 0 < own < made and stats["tier"] == "mega"
    assert got == pytest.approx(100.0 * own / made)


def test_a_tiny_run_is_correct(tiny):
    with one_thread():
        out = run.run_cell(tiny, 2**32 + 9, 0.0, False, "cpu", log=lambda m: None,
                           cache_dir=None)
    result = out["result"]
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["attempted"] == tiny.traffic["loop_frames"]
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_the_control_fails_the_limits(tiny):
    seed = 2**32 + 21
    with one_thread():
        out = run.run_cell(tiny, seed, 0.0, False, "cpu", log=lambda m: None,
                           cache_dir=None)
        exact = readings.control_numbers(tiny, seed, out["check"], "cpu", torch.float32)
        low = readings.control_numbers(tiny, seed, out["check"], "cpu", torch.bfloat16)
    assert exact == {"over_share": 0.0, "gap_mean": 0.0}
    assert not check.passed(check.judge(low, tiny.limits["limits"])), low
