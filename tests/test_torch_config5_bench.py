"""The benchmark's config5 (``rtbench/configs/config5.json``: the spinning
mirror teapot stand-in and the orbiting glass cube, 1 spp, 3 bounces)
through the port's normal path on the CPU, and what the per-lane walk
counts on the waves past the first bounce:

* ``meshes/box.py`` is upstream's ``cube.obj``: 24 vertices, 12 triangles,
  flat outward normals, extent +-1; ``scenes.config5_standin`` renders the
  same cube;
* the port's ``Renderer``, built by ``rtbench.run.port_renderer`` at
  128x64 (8 tiles at 1 spp, one whole block), takes the per-lane tier, and
  its frames at three poses of ``closeup`` match the plain reference at
  every pixel under ``limits/config5.closeup.json``, with most primary
  samples on the glass and some of those reaching the mirror;
* K1's and K2's later entries (``_build.work_counts``, ``.later``) hold
  the waves after the first bounce: a frame's entries are the first
  bounce's (the same frame at ``max_bounce_count`` 0) plus its later ones,
  key by key, and a frame with no bounce after the first counts nothing
  there; K2 never runs (no surface is diffuse, so no lane is lit);
* on the tiny bench, a correct run of config5.closeup, and the reference
  in bfloat16 in the program's place not correct.

The card's side (K1's and K2's counts against the plain walks', K1
replayed inside ``rt.later``) is in ``tests/test_torch_cuda.py``.

No JAX: the port and the benchmark alone."""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu_torch import _build, integrator, scenes
from rtbench import camerapath, check, manifest, readings, run
from rtbench.reference import scene_math
from rtbench.reference.whitted import RAY_TMAX, Reference
from rtbench.tests.conftest import make_tiny_bench

BENCH = Path(run.__file__).resolve().parent
CELL = "config5.closeup"
SIZE = {"width": 128, "height": 64}    # 4 x 2 tiles x 1 spp: one block
SEED = 2**33 + 31
POSES = (0, 41, 87)
SWEEPS = ("perlane_closest_sweep", "perlane_anyhit_sweep")
MIRROR, GLASS = 0, 1                    # the configuration's objects


@contextlib.contextmanager
def one_thread():
    """One intra-op thread for the block, as ``tests/torch_twin.one_thread``
    (which imports the JAX package; this file needs none)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_the_box_is_cube_obj():
    pos, nrm, tris = run.make_mesh(BENCH, {"generator": "box"})
    assert pos.shape == nrm.shape == (24, 3) and tris.shape == (12, 3)
    assert pos.dtype == nrm.dtype == np.float32 and tris.dtype == np.int32
    assert np.array_equal(np.unique(tris), np.arange(24))
    v0, v1, v2 = (pos[tris[:, k]].astype(np.float64) for k in range(3))
    face = np.cross(v1 - v0, v2 - v0)
    face /= np.linalg.norm(face, axis=1, keepdims=True)
    assert np.all(np.sum(face * (v0 + v1 + v2), axis=1) > 0)      # outward
    for k in range(3):                    # each vertex's normal is its face's
        np.testing.assert_array_equal(nrm[tris[:, k]], face.astype(np.float32))
    assert pos.min() == -1.0 and pos.max() == 1.0
    assert np.all(np.abs(pos) == 1.0)     # corners only
    assert sorted(map(tuple, np.unique(np.abs(face.round(6)), axis=0))) == \
        [(0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)]


def test_the_port_stand_in_renders_the_same_cube():
    want = run.make_mesh(BENCH, {"generator": "box"})
    cube = scenes.config5_standin(sky_size=4, width=32, height=32).meshes[1]
    for got, w in zip((cube.positions, cube.normals, cube.triangles), want):
        np.testing.assert_array_equal(got, w)
    assert scenes.box_mesh((0, 0, 0), 1.0).positions.shape == (8, 3)   # kept


@pytest.fixture(scope="module")
def bench():
    """The cell's configuration at the test size with an 8-texel sky, its
    meshes, sky, poses and limits, and the port's Renderer of it."""
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


def _paths(ref, camera, pixels, bounces):
    """Per primary sample of ``pixels``: the instance its primary ray hits
    (-1 for the sky) and whether its chain of mirror and glass bounces
    hits the mirror after the first hit, as the reference's loop follows
    it."""
    px, py = (torch.as_tensor(pixels[:, i], dtype=torch.float32) for i in (0, 1))
    o, d = ref.primary(camera, px, py, torch.zeros_like(px))
    n = o.shape[0]
    first, reached = None, torch.zeros(n, dtype=torch.bool)
    live = torch.arange(n)
    for j in range(bounces + 1):
        t, inst, prim, u, v = ref.closest(o[live], d[live],
                                          torch.full((live.numel(),), RAY_TMAX))
        if j == 0:
            first = inst.clone()
        else:
            reached[live[inst == MIRROR]] = True
        hit = inst >= 0
        live, t, inst, prim, u, v = (x[hit] for x in (live, t, inst, prim, u, v))
        pos = o[live] + t[:, None] * d[live]
        nrm = ref.normal(inst, prim, u, v)
        mo, md = ref._mirror(pos, nrm, d[live])
        ro, rd = ref._refract(pos, nrm, d[live])
        mirror = (inst == MIRROR)[:, None]
        o[live], d[live] = torch.where(mirror, mo, ro), torch.where(mirror, md, rd)
    return first, reached


@pytest.mark.parametrize("k", POSES)
def test_config5_closeup_frames_match_the_reference(bench, k):
    cell, cfg, meshes, sky, poses, tps, viewer = bench
    assert meshes[0][2].shape == (5120, 3) and meshes[1][2].shape == (12, 3)
    r = _at(viewer, poses, tps, k)
    stats = {}
    img = r.render(stats=stats).numpy()
    assert stats["tier"] == "perlane"
    assert img.shape == (SIZE["height"], SIZE["width"], 3)

    ref = Reference(cfg, meshes, torch.as_tensor(sky), "cpu")
    ref.set_history([tps[k]])
    ys, xs = np.mgrid[:SIZE["height"], :SIZE["width"]]
    pixels = np.stack([xs.ravel(), ys.ravel()], axis=1)
    pose = poses[k]
    camera = scene_math.basis(pose["position"], pose["yaw"], pose["pitch"])
    want = ref.render(camera, pixels).numpy()
    gaps = check.gaps(img[pixels[:, 1], pixels[:, 0]], want)
    judged = check.judge(check.numbers([gaps], cell.limits["gap_threshold"]),
                         cell.limits["limits"])
    assert check.passed(judged), judged
    assert float(want.std()) > 0.02               # not a flat frame

    first, reached = _paths(ref, camera, pixels, cfg["max_bounce_count"])
    glass = first == GLASS
    assert float(glass.float().mean()) > 0.5      # most samples enter the glass
    assert 0 < int((glass & reached).sum())       # and some reach the mirror


@pytest.fixture(scope="module")
def counts(bench):
    """``_build.work_counts()`` of the frame at pose 41 rendered with
    ``stats`` at the configuration's 3 bounces and at none."""
    _, _, _, _, poses, tps, viewer = bench
    r = _at(viewer, poses, tps, 41)
    out = {}
    with one_thread():
        for bounces in (3, 0):
            rs = dataclasses.replace(r.render_static, max_bounce_count=bounces)
            _build.reset_work_counts()
            st = {}
            integrator.render_frame(r.tscene, rs, r.camera_tensor(), stats=st)
            assert st["tier"] == "perlane"
            out[bounces] = _build.work_counts()
    _build.reset_work_counts()
    return out


@pytest.mark.parametrize("kernel", SWEEPS)
def test_the_later_entries_split_the_totals(counts, kernel):
    """Per kernel and key: the frame's total is its first bounce's (the
    frame without a bounce after it) plus its later waves'."""
    keys = _build.WORK_KEYS[kernel]
    assert _build.WORK_KEYS[kernel + _build.LATER] == keys
    total, later = counts[3][kernel], counts[3][kernel + _build.LATER]
    first = counts[0][kernel]
    for key in keys:
        assert total[key] == first[key] + later[key], (key, total, first, later)
    if kernel == "perlane_closest_sweep":  # refracted and reflected waves walk
        assert all(later[key] > 0 for key in keys), later
        assert 0 < later["fetches"] <= later["nodes"]
    else:                                  # no surface is diffuse: no lit lane
        assert sum(total.values()) == 0


def test_no_later_counts_without_a_bounce(counts):
    assert all(counts[0][k + _build.LATER] == dict.fromkeys(_build.WORK_KEYS[k], 0)
               for k in SWEEPS)
    assert sum(counts[0]["perlane_closest_sweep"].values()) > 0


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The cell on the tiny bench (32x18, the teapot at depth 1)."""
    bench = make_tiny_bench(tmp_path_factory.mktemp("tiny5"))
    return manifest.Cell(manifest.load(bench.parent / "BENCHMARK.json"), CELL, bench)


def test_a_tiny_run_is_correct(tiny):
    with one_thread():
        out = run.run_cell(tiny, 2**32 + 11, 0.0, False, "cpu", log=lambda m: None,
                           cache_dir=None)
    result = out["result"]
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["attempted"] == tiny.traffic["loop_frames"]
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_the_control_fails_the_limits(tiny):
    seed = 2**32 + 23
    with one_thread():
        out = run.run_cell(tiny, seed, 0.0, False, "cpu", log=lambda m: None,
                           cache_dir=None)
        exact = readings.control_numbers(tiny, seed, out["check"], "cpu", torch.float32)
        low = readings.control_numbers(tiny, seed, out["check"], "cpu", torch.bfloat16)
    assert exact == {"over_share": 0.0, "gap_mean": 0.0}
    assert not check.passed(check.judge(low, tiny.limits["limits"])), low
