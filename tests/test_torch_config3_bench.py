"""The benchmark's config3 (``rtbench/configs/config3.json``: the refractive
Cornell stand-in of ``rtbench/meshes/cornell.py``) through the port's
normal path on the CPU, and what the consensus walk counts:

* the frozen mesh equals ``scenes.cornell_mesh()`` bit for bit;
* the port's ``Renderer``, built by ``rtbench.run.port_renderer`` at a size
  whose waves are whole blocks of 32x32 tiles, takes the consensus tier,
  and its frames at three poses of ``closeup_front`` match the plain
  reference at every pixel under ``limits/config3.closeup.json``;
* the plain consensus walk's own counts (``own_nodes``, ``own_tests``) are
  at most its counts and equal the visits and tests of groups of one lane,
  its visits those of the lanes walking alone, over the same wide links and
  entry order, on the primary wave, a refracted wave and shadow rays;
* a consensus frame rendered with ``stats`` adds the plain walks' four
  counts to K8's and K9's work counts (``_build.work_counts``).

No JAX: the port and the benchmark alone."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu_torch import _build, integrator, scenes
from raytpu_torch.config import RAY_TMAX, RAY_TMIN
from raytpu_torch.integrator import tiled_pixels
from raytpu_torch.ops import consensus, perlane, raygen, shade, traverse
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.mega import BLOCK_PACKETS
from rtbench import camerapath, check, manifest, run
from rtbench.reference import scene_math
from rtbench.reference.whitted import Reference
from tests.torch_twin import one_thread

BENCH = Path(run.__file__).resolve().parent
CELL = "config3.closeup"
SIZE = {"width": 64, "height": 32}     # 2 x 1 tiles x 4 spp: one block
SEED = 2**33 + 17
POSES = (0, 41, 87)


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


def test_the_frozen_cornell_mesh_is_the_ports():
    pos, nrm, tri = run.make_mesh(BENCH, {"generator": "cornell"})
    want = scenes.cornell_mesh()
    assert (pos.dtype, nrm.dtype, tri.dtype) == (np.float32, np.float32, np.int32)
    assert np.array_equal(pos.view(np.uint32), want.positions.view(np.uint32))
    assert np.array_equal(nrm.view(np.uint32), want.normals.view(np.uint32))
    assert np.array_equal(tri, want.triangles) and tri.shape == (46, 3)
    with pytest.raises(ValueError, match="no parameters"):
        run.make_mesh(BENCH, {"generator": "cornell", "depth": 1})


@pytest.mark.parametrize("k", POSES)
def test_config3_closeup_frames_match_the_reference(bench, k):
    cell, cfg, meshes, sky, poses, tps, viewer = bench
    r = viewer.renderer
    viewer.pose(poses[k])
    r.set_transforms(tps[k])
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
    assert st["primary_hit_share"] == 1.0          # every sample hits glass
    gaps = check.gaps(img[pixels[:, 1], pixels[:, 0]], want)
    judged = check.judge(check.numbers([gaps], cell.limits["gap_threshold"]),
                         cell.limits["limits"])
    assert check.passed(judged), judged
    assert float(want.std()) > 0.02               # not a flat frame


def _waves(bench):
    """The primary wave of pose 41 and its refracted wave (no hit: dead),
    each as (rays (6, P, K), window (P, K)), with shadow rays from the
    primary wave's hits toward the light and their windows."""
    _, _, _, _, poses, tps, viewer = bench
    r = viewer.renderer
    viewer.pose(poses[41])
    r.set_transforms(tps[41])
    rs, ts = r.render_static, r.tscene
    spp = rs.samples_per_pixel
    (px, py), act = tiled_pixels(rs, "cpu")
    s_row = torch.arange(spp, dtype=torch.float32).repeat(px.shape[0])
    rays = raygen.raygen_packed(r.camera_tensor(), s_row, px.repeat_interleave(spp, 0),
                                py.repeat_interleave(spp, 0), spp, rs.width, rs.height)
    win = torch.where(act.repeat_interleave(spp, 0), RAY_TMAX, 0.0).float()
    # the frame's packets, without the dead ones that pad them to a segment
    n = -(-int(win.gt(0).any(1).sum()) // BLOCK_PACKETS) * BLOCK_PACKETS
    rays, win = rays[:, :n].contiguous(), win[:n].contiguous()
    hits = consensus.mega_closest_sweep_ref(ts, rays, RAY_TMIN,
                                            traverse.make_trace_state(win))
    t, valid, _, _, nrm, _, _ = traverse.unpack_state(hits)
    o, d = tuple(rays[:3]), tuple(rays[3:])
    pos = v3.add(o, v3.scale(torch.where(valid, t, 0.0), d))
    ro, rd = shade.refract_bounce_soa(d, v3.normalize(nrm), pos)
    refracted = (torch.stack((*ro, *rd)).contiguous(),
                 torch.where(valid, RAY_TMAX, 0.0).float())
    to_l = tuple(ts.light_pos[c] - pos[c] for c in range(3))
    dist = v3.norm(to_l)
    so = v3.add(pos, v3.scale(1e-2, v3.normalize(nrm)))
    ld = v3.scale(1.0 / torch.clamp_min(dist, 1e-30), to_l)
    shadow = (torch.stack((*so, *ld)).contiguous(), torch.where(valid, dist, 0.0))
    return {"primary": (rays, win), "refracted": refracted, "shadow": shadow}


@pytest.fixture(scope="module")
def waves(bench):
    with one_thread():
        return _waves(bench)


@pytest.mark.parametrize("wave", ["primary", "refracted", "shadow"])
def test_consensus_own_counts_are_the_lanes_own_walks(bench, waves, wave):
    ts = bench[-1].renderer.tscene
    rays, win = waves[wave]
    live = win > RAY_TMIN
    assert 0.3 < live.float().mean() <= 1.0
    rows, walks, links = perlane.plain_schedule(ts, rays, win, RAY_TMIN, "origin",
                                                consensus.wide_links(ts))
    counts, out = {}, {}
    for group in (0, 1, consensus.WARP):
        counts[group] = {}
        if wave == "shadow":
            out[group] = traverse.anyhit_ref(
                ts, rays, RAY_TMIN, win, torch.zeros(win.shape, dtype=torch.int32),
                rows, walks, links, counts[group], consensus=group)
        else:
            out[group] = traverse.closest_ref(
                ts, rays, RAY_TMIN, traverse.make_trace_state(win), rows, walks,
                links, counts=counts[group], consensus=group).view(torch.int32)
    assert torch.equal(out[0], out[consensus.WARP])
    assert torch.equal(out[1], out[consensus.WARP])
    alone, one, warp = counts[0], counts[1], counts[consensus.WARP]
    # the warp's own counts: at most its counts, and those of the lanes'
    # own walks, which visit the nodes a lane alone visits
    assert 0 < warp["own_nodes"] < warp["nodes"]
    assert 0 < warp["own_tests"] <= warp["tests"]
    assert warp["own_nodes"] == alone["nodes"] == one["nodes"]
    assert warp["own_tests"] == one["tests"]
    # a group of one lane needs all it does; a lane alone tests a leaf on
    # arrival, so its tests add those of the leaves whose box misses it
    assert (one["own_nodes"], one["own_tests"]) == (one["nodes"], one["tests"])
    assert one["tests"] < alone["tests"] and "own_tests" not in alone


def test_a_consensus_frame_with_stats_counts_the_plain_walks_work(bench):
    """A config3 frame rendered with ``stats`` adds the plain consensus
    walks' four counts to K8's and K9's work counts and nothing to K1's
    and K2's; one rendered without adds nothing."""
    _, _, _, _, poses, tps, viewer = bench
    r = viewer.renderer
    viewer.pose(poses[87])
    r.set_transforms(tps[87])
    mine = {"mega_closest_sweep": {}, "mega_anyhit_sweep": {}}

    def closest(ts, rays, tmin, state):
        return consensus.mega_closest_sweep_ref(
            ts, rays, tmin, state, counts=mine["mega_closest_sweep"])

    def anyhit(ts, rays, tmin, tmax, occ, order="light"):
        return consensus.mega_anyhit_sweep_ref(
            ts, rays, tmin, tmax, occ, order, counts=mine["mega_anyhit_sweep"])

    zero = {k: dict.fromkeys(keys, 0) for k, keys in _build.WORK_KEYS.items()}
    _build.reset_work_counts()
    r.render()
    assert _build.work_counts() == zero
    with integrator.kernels(mega_closest=closest, mega_anyhit=anyhit):
        r.render(stats={})
    got = _build.work_counts()
    _build.reset_work_counts()
    keys = ("nodes", "tests", "own_nodes", "own_tests")
    assert set(_build.WORK_KEYS["mega_closest_sweep"]) == set(keys)
    assert all(got[k] == zero[k] for k in ("perlane_closest_sweep",
                                           "perlane_anyhit_sweep"))
    closest_work = mine["mega_closest_sweep"]
    assert 0 < closest_work["own_nodes"] < closest_work["nodes"]
    for k, c in mine.items():
        assert got[k] == {key: c.get(key, 0) for key in keys}, k


class _Trace:
    """A traced loop of two frames with these kernels' device ms a frame."""
    frames = 2
    ms = {"mega_closest_sweep_kernel": 0.3, "mega_anyhit_sweep_kernel": 0.1,
          "perlane_closest_sweep_kernel": 5.0}

    def kernel_ms_per_frame(self, match):
        return sum(v for k, v in self.ms.items() if match(k))


def test_the_consensus_readers_read_the_own_counts(monkeypatch):
    """``consensus.*``'s readers: K8 + K9's device ms, the least time of the
    own counts' operations over it, and the own counts' share of the
    operations; each reads nothing where the program does not count the
    consensus sweeps (the parent commit's ``work_counts``)."""
    from types import SimpleNamespace

    read = {m: manifest.load_reader(BENCH / "metrics" / f"consensus.{m}.py")
            for m in ("device_ms", "roofline_pct", "useful_pct")}
    work = {"perlane_closest_sweep": {"nodes": 7, "tests": 3},
            "perlane_anyhit_sweep": {"nodes": 0, "tests": 0},
            "mega_closest_sweep": {"nodes": 1000, "tests": 400,
                                   "own_nodes": 900, "own_tests": 300},
            "mega_anyhit_sweep": {"nodes": 100, "tests": 0,
                                  "own_nodes": 100, "own_tests": 0}}
    monkeypatch.setattr(_build, "work_counts", lambda: work)
    ctx = SimpleNamespace(trace=_Trace(), stats={"frames": 2}, ops_per_s=1e12)
    own, made = 1000 * 23 + 300 * 51, 1100 * 23 + 400 * 51
    assert read["device_ms"](ctx) == pytest.approx(0.4)
    assert read["useful_pct"](ctx) == pytest.approx(100.0 * own / made)
    assert read["roofline_pct"](ctx) == pytest.approx(
        100.0 * (own / 1e12 * 1e3 / 2) / 0.4)
    assert read["roofline_pct"](SimpleNamespace(**dict(vars(ctx), ops_per_s=0.0))) is None
    for k in ("mega_closest_sweep", "mega_anyhit_sweep"):
        del work[k]
    assert all(r(ctx) is None for r in read.values())
