"""The JAX package's XLA-body path in the PyTorch port, on the CPU:

* the plain one-mesh walks (``mesh_closest_ref`` / ``mesh_anyhit_ref``, the
  function of K11a / K11b; their warp-grouped walks equal each lane's
  walk alone) against the interpret-mode ``pallas_closest`` /
  ``pallas_anyhit`` on ``tests/test_pallas.py``'s random mesh and on the two
  entries of a ``from_raytpu`` twin mesh chunked in two: slots and
  occlusion exact, t, u and v within 4 f32 ulps, the normal within 1e-6;
  and against ``packet_closest`` / ``packet_anyhit``, which the JAX
  package's ``"xla"`` tier runs: ``slot_to_prim`` equals the prim, the
  flags are equal;
* the per-(instance, mesh) loop (``closest_hit_loop`` / ``any_hit_loop``)
  against raytpu's ``closest_hit_wave`` / ``any_hit_wave`` with
  ``traversal="xla"`` on a twin scene of seven entries: valid, inst and mat
  exact, t within 4 ulps, the normal within 1e-5, occlusion exact;
* an ``"xla"`` frame against raytpu's ``"xla"`` frame from the same primary
  rays (1e-5 per pixel, SSIM > 0.98);
* the XLA body's per-iteration resort (``body_compact``): compacted
  ``"xla"`` frames equal full-width ones bit for bit; on the tie scene
  ``"xla"`` finds the pallas tier's hits on the primary wave, bit for bit,
  and its frame is within 1e-6 of the pallas tier's fused frame;
* the port's native trees against the committed library's.

The JAX sides run in a child process without FMA (``--xla_cpu_max_isa=AVX``,
as in ``test_torch_traverse.py``), where XLA:CPU rounds every operation as
the port does.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.ops import packet as jpacket
from raytpu.ops import trace as jtrace
from raytpu.ops import traverse_pallas as tp
from raytpu.render import Renderer as JaxRenderer
from raytpu.utils.ssim import ssim
from raytpu_torch import integrator, scenes
from raytpu_torch.accel import native
from raytpu_torch.config import RAY_TMAX, RAY_TMIN
from raytpu_torch.device_scene import TorchScene, from_raytpu
from raytpu_torch.integrator import render_frame
from raytpu_torch.io.genmesh import armadillo_standin, generate_highpoly
from raytpu_torch.ops import trace, traverse
from raytpu_torch.ops.raygen import raygen_packed_ref
from raytpu_torch.render import Renderer
from tests.test_pallas import _setup
from tests.test_torch_frame import _same_rays_frames
from tests.test_torch_traverse import _within_ulps
from tests.torch_twin import one_thread, raytpu_twin

P, K = 4, tp.PACKET_K
TMIN = 1e-3
T_ANIM = 0.1
NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent
MESHES = ("random", "twin")


def _twin_renderer():
    """The teapot stand-in alone, chunked into two entries (595 and 585
    nodes, 2,560 slots each)."""
    return JaxRenderer(raytpu_twin(scenes.config2_standin(
        16, width=32, height=32, chunk_tris=2560, traversal="pallas")))


def _loop_renderer():
    """Three instances in motion, chunked into seven entries, on the JAX
    package's XLA tier."""
    jr = JaxRenderer(raytpu_twin(scenes.mixed_scene(
        32, 32, 1, 1, depth=2, chunk_tris=128, traversal="xla")))
    jr.set_transforms(T_ANIM)
    return jr


def _inputs(seed: int, spread: float, p: int = P):
    """Seeded rays (6, p, K) from 8-14 away toward a box of half width
    ``spread``, a closest window (p, K) with dead lanes and a dead packet,
    and a shadow window (p, K)."""
    rng = np.random.default_rng(seed)
    n = p * K
    u = rng.normal(size=(n, 3))
    o = u / np.linalg.norm(u, axis=1, keepdims=True) * rng.uniform(8, 14, (n, 1))
    d = rng.uniform(-spread, spread, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o.T, d.T]).astype(np.float32).reshape(6, p, K)
    win = np.full((p, K), 1e4, np.float32)
    win.reshape(-1)[3::7] = 0.0
    win[1] = 0.0
    tmax = np.where(win > 0, rng.uniform(0.0, 20.0, win.shape), 0.0)
    return rays, win, tmax.astype(np.float32)


MESH_INPUTS = {"random": (11, 1.2), "twin": (12, 3.5)}


def _mesh_scenes():
    """name -> (raytpu DeviceScene, SceneStatic, the mesh id of each entry)."""
    dev, static, _ = _setup(np.random.default_rng(3))
    jr = _twin_renderer()
    return {"random": (dev, static, [0]),
            "twin": (jr.device_scene, jr.static,
                     [m for _, m in jr.static.traversal_list])}


def _port_scene(name, dev, static) -> TorchScene:
    """The port's scene over the same tables (the random mesh has no sky,
    so only what the one-mesh walks read is carried)."""
    if name == "twin":
        return from_raytpu(dev, static, "cpu")

    def t(x):
        return torch.as_tensor(np.array(x))

    return TorchScene(
        device=torch.device("cpu"), o2w=t(dev.o2w), w2o=t(dev.w2o),
        materials=t(dev.materials), light_pos=t(dev.light_pos),
        light_intensity=t(dev.light_intensity), tri_n_soa=t(dev.tri_n_soa),
        skybox_u32=torch.zeros(6, dtype=torch.int32), sky_hw=(1, 1),
        instance_mesh=(0,), light=(0.0, 0.0, 0.0, 1.0),
        bvh_aabb_min=t(dev.bvh_aabb_min), bvh_aabb_max=t(dev.bvh_aabb_max),
        bvh_tri_first=t(dev.bvh_tri_first), bvh_tri_count=t(dev.bvh_tri_count),
        bvh_miss=t(dev.bvh_miss), bvh_tri_v0=t(dev.bvh_tri_v0),
        bvh_tri_e1=t(dev.bvh_tri_e1), bvh_tri_e2=t(dev.bvh_tri_e2),
        bvh_tri_prim=t(dev.bvh_tri_prim), bvh_tri_n_soa=t(dev.bvh_tri_n_soa),
        entry_rows=((0, 0, 0, static.mesh_node_ranges[0][1], 0),),
        leaf_max=int(np.max(dev.bvh_tri_count)))


_pallas_closest = jax.jit(tp.pallas_closest, static_argnums=(1, 2, 5))
_pallas_anyhit = jax.jit(tp.pallas_anyhit, static_argnums=(1, 2, 5))
_packet_closest = jax.jit(jpacket.packet_closest, static_argnums=(1, 2, 5))
_packet_anyhit = jax.jit(jpacket.packet_anyhit, static_argnums=(1, 2, 5))


def _jax_side(out_path):
    """The JAX one-mesh walks per entry, and the XLA loop, into an npz."""
    res = {}
    for name, (dev, static, mesh_ids) in _mesh_scenes().items():
        rays, win, tmax = _inputs(*MESH_INPUTS[name])
        o = tuple(jnp.asarray(rays[c]) for c in range(3))
        d = tuple(jnp.asarray(rays[3 + c]) for c in range(3))
        for e, mesh in enumerate(mesh_ids):
            key = f"{name}{e}"
            t, slot, u, v, n = _pallas_closest(dev, static, mesh, o, d, TMIN,
                                               jnp.asarray(win))
            res.update({f"{key}_t": t, f"{key}_slot": slot, f"{key}_u": u,
                        f"{key}_v": v, f"{key}_n": jnp.stack(n)})
            res[f"{key}_occ"] = _pallas_anyhit(dev, static, mesh, o, d, TMIN,
                                               jnp.asarray(tmax))
            res[f"{key}_prim"] = _packet_closest(dev, static, mesh, o, d, TMIN,
                                                 jnp.asarray(win))[1]
            res[f"{key}_pocc"] = _packet_anyhit(dev, static, mesh, o, d, TMIN,
                                                jnp.asarray(tmax))
        res[f"{name}_bvh_tri_v0"] = dev.bvh_tri_v0

    jr = _loop_renderer()
    rays, win, tmax = _inputs(13, 3.5, p=8)
    o = tuple(jnp.asarray(rays[c]) for c in range(3))
    d = tuple(jnp.asarray(rays[3 + c]) for c in range(3))
    hit = jax.jit(jtrace.closest_hit_wave, static_argnums=(1, 4))(
        jr.device_scene, jr.static, o, d, TMIN, jnp.asarray(win))
    res.update({"loop_t": hit.t, "loop_valid": hit.valid, "loop_mat": hit.mat,
                "loop_inst": hit.inst, "loop_n": jnp.stack(hit.n)})
    res["loop_occ"] = jax.jit(jtrace.any_hit_wave, static_argnums=(1, 4))(
        jr.device_scene, jr.static, o, d, TMIN, jnp.asarray(tmax))
    res["loop_w2o"] = jr.device_scene.w2o
    np.savez(out_path, **{k: np.asarray(v) for k, v in res.items()})


def _child(tmp_path, *args, timeout=900):
    """Run this file's ``__main__`` with ``args`` in a no-FMA JAX process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, *map(str, args)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshwalk") / "jax_side.npz"
    _child(out.parent, "walks", out)
    want = dict(np.load(out))
    scenes_ = {name: _port_scene(name, dev, static)
               for name, (dev, static, _) in _mesh_scenes().items()}
    for name, ts in scenes_.items():   # both walk the same tables
        np.testing.assert_array_equal(ts.bvh_tri_v0.numpy(),
                                      want[f"{name}_bvh_tri_v0"])
    return scenes_, want


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("name", MESHES)
def test_mesh_walks_match_pallas_kernels(rig, name):
    """Plain K11a / K11b against the interpret-mode K11a / K11b, entry by
    entry."""
    scenes_, want = rig
    ts = scenes_[name]
    rays, win, tmax = (torch.from_numpy(x) for x in _inputs(*MESH_INPUTS[name]))
    assert len(ts.entry_rows) == {"random": 1, "twin": 2}[name]
    for e, row in enumerate(ts.entry_rows):
        key = f"{name}{e}"
        t, slot, u, v, n = traverse.mesh_closest_ref(ts, row[2:], rays, TMIN,
                                                     win)
        np.testing.assert_array_equal(slot.numpy(), want[f"{key}_slot"])
        found = slot.numpy() >= 0
        assert 0.05 < found.mean() < 0.9, found.mean()
        for got, ref in ((t, "t"), (u, "u"), (v, "v")):
            assert _within_ulps(got.numpy(), want[f"{key}_{ref}"], 4).all(), ref
        np.testing.assert_allclose(torch.stack(n).numpy(), want[f"{key}_n"],
                                   rtol=0, atol=1e-6)
        occ = traverse.mesh_anyhit_ref(ts, row[2:], rays, TMIN, tmax)
        np.testing.assert_array_equal(occ.numpy(), want[f"{key}_occ"])
        assert 0.02 < occ.numpy().mean() < 0.9


@pytest.mark.parametrize("name", [*MESHES, "tie"])
def test_lane_alone_walk_equals_warp_walk(rig, name):
    """K11a's plain walk, its lanes grouped by warps as the kernel walks
    (the TPU packet's vote), against the same walk with each lane alone, as
    K10a's lanes walk: slot, t, u, v and the normal equal bit for bit on
    every entry, so the vote moves no hit. The tie scene's two boxes are
    hit at exactly the same t through both entries, and each box's faces
    meet in edges and diagonals."""
    if name == "tie":
        ts = Renderer(scenes.tie_scene(), "cpu").tscene
        rays, win, _ = (torch.from_numpy(x) for x in _inputs(14, 0.8))
    else:
        ts = rig[0][name]
        rays, win, _ = (torch.from_numpy(x) for x in _inputs(*MESH_INPUTS[name]))
    hits = 0
    for row in ts.entry_rows:
        warp = traverse.mesh_closest_ref(ts, row[2:], rays, TMIN, win)
        alone = traverse.mesh_closest_ref(ts, row[2:], rays, TMIN, win,
                                          consensus=0)
        for a, b in zip((*alone[:4], *alone[4]), (*warp[:4], *warp[4])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        hits += int((alone[1] >= 0).sum())
    assert hits > 0.05 * rays[0].numel() * len(ts.entry_rows)


@pytest.mark.parametrize("name", [*MESHES, "tie"])
def test_lane_alone_anyhit_equals_warp_anyhit(rig, name):
    """K11b's plain walk, its lanes grouped by warps as the kernel walks,
    against the same walk with each lane alone, as K10b's lanes walk: the
    occlusion flags equal on every lane of every entry, so the vote moves
    no flag. Both occluded and open lanes occur."""
    if name == "tie":
        ts = Renderer(scenes.tie_scene(), "cpu").tscene
        rays, _, tmax = (torch.from_numpy(x) for x in _inputs(14, 0.8))
    else:
        ts = rig[0][name]
        rays, _, tmax = (torch.from_numpy(x) for x in _inputs(*MESH_INPUTS[name]))
    occluded = 0
    for row in ts.entry_rows:
        warp = traverse.mesh_anyhit_ref(ts, row[2:], rays, TMIN, tmax)
        alone = traverse.mesh_anyhit_ref(ts, row[2:], rays, TMIN, tmax,
                                         consensus=0)
        assert torch.equal(alone, warp)
        occluded += int(alone.sum())
    lanes = rays[0].numel() * len(ts.entry_rows)
    assert 0.02 * lanes < occluded < 0.9 * lanes


@pytest.mark.parametrize("name", MESHES)
def test_mesh_walks_match_packet_walks(rig, name):
    """What the JAX package's ``"xla"`` tier runs per entry: the hit
    primitive (``slot_to_prim``) and the occlusion flags on every lane."""
    scenes_, want = rig
    ts = scenes_[name]
    rays, win, tmax = (torch.from_numpy(x) for x in _inputs(*MESH_INPUTS[name]))
    for e, row in enumerate(ts.entry_rows):
        slot = traverse.mesh_closest(ts, row[2:], rays, TMIN, win)[1]
        prim = traverse.slot_to_prim(ts, row[2:], slot)
        np.testing.assert_array_equal(prim.numpy(), want[f"{name}{e}_prim"])
        np.testing.assert_array_equal(
            traverse.mesh_anyhit(ts, row[2:], rays, TMIN, tmax).numpy(),
            want[f"{name}{e}_pocc"])


def test_loop_matches_raytpu_xla_wave(rig):
    """The per-(instance, mesh) loop against raytpu's ``closest_hit_wave``
    and ``any_hit_wave`` under ``traversal="xla"``."""
    _, want = rig
    jr = _loop_renderer()
    ts = from_raytpu(jr.device_scene, jr.static, "cpu")
    assert ts.traversal == "xla" and len(ts.entry_rows) == 7
    np.testing.assert_array_equal(ts.w2o.numpy(), want["loop_w2o"])
    rays, win, tmax = (torch.from_numpy(x) for x in _inputs(13, 3.5, p=8))
    o, d = tuple(rays[:3]), tuple(rays[3:])
    hit = trace.closest_hit_loop(ts, o, d, TMIN, win)
    for field in ("valid", "inst", "mat"):
        np.testing.assert_array_equal(getattr(hit, field).numpy(),
                                      want[f"loop_{field}"])
    assert 0.2 < hit.valid.float().mean() < 0.9
    assert len(set(hit.inst[hit.valid].tolist())) == 3   # every instance hit
    assert _within_ulps(hit.t.numpy(), want["loop_t"], 4).all()
    np.testing.assert_allclose(torch.stack(hit.n).numpy(), want["loop_n"],
                               rtol=0, atol=1e-5)
    occ = trace.any_hit_loop(ts, o, d, TMIN, tmax)
    np.testing.assert_array_equal(occ.numpy(), want["loop_occ"])
    assert 0.05 < occ.float().mean() < 0.9
    # the chained sweeps walk the same entries in the same build order:
    # the same hit wave, bit for bit
    chained = trace.closest_hit_wave(ts, o, d, TMIN, win,
                                     sweep=traverse.closest_sweep_ref)
    for field in hit._fields:
        a, b = getattr(hit, field), getattr(chained, field)
        for x, y in zip(*((a, b) if field == "n" else ((a,), (b,)))):
            assert torch.equal(x, y), field


def _xla_frames():
    return _same_rays_frames(64, 48, 2, 3, tier="xla", traversal="xla")


def test_xla_frame_matches_raytpu(tmp_path):
    """From the same primary rays, the port's ``"xla"`` frame (the body,
    the loop on K11a/K11b) against raytpu's ``"xla"`` frame (its XLA body
    on ``packet_closest``), both in the no-FMA child."""
    out = tmp_path / "frames.npz"
    _child(tmp_path, "frame", out)
    frames = np.load(out)
    got, want = frames["got"], frames["want"]
    assert got.shape == want.shape == (48, 64, 3)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ssim(got, want) > 0.98


def _frame_widths(ts, rs, cam, budget=None):
    """The frame, its tier, and the packet width of every ``_bounce_core``
    call; ``budget``, if given, replaces the compacted waves' budget."""
    widths = []
    core = integrator._bounce_core

    def spy(ts, rs, o, *args):
        widths.append(o[0].shape[0])
        return core(ts, rs, o, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, "_bounce_core", spy)
        if budget:
            mp.setattr(integrator, "_wave_budget", lambda p: budget)
        stats = {}
        img = render_frame(ts, rs, cam, stats=stats)
    return img, stats["tier"], widths


@pytest.mark.parametrize("traversal", ["xla"])
def test_body_compact_equals_full_width(traversal):
    """``body_compact``: from the same scene and rays, the compacted XLA
    body's frames equal the full-width body's bit for bit. At 128x96 the
    32x32 tiles make 128 packets of 1024 lanes (budget 64), 24 of them in
    the frame; with the budget cut to 8, the iterations after the peeled
    first run several waves."""
    r = Renderer(scenes.mixed_scene(128, 96, 2, 3), "cpu")
    r.set_transforms(T_ANIM)
    ts = dataclasses.replace(r.tscene, traversal=traversal)
    rs = r.render_static
    cam = r.camera_tensor()
    full, tier, widths = _frame_widths(ts, dataclasses.replace(
        rs, wavefront="full"), cam)
    assert tier == traversal and full.std() > 0.05
    assert len(widths) == 4 and set(widths) == {128}
    for budget, wave in ((None, 64), (8, 8)):
        img, tier, widths = _frame_widths(ts, rs, cam, budget)
        assert tier == traversal
        assert widths[0] == 128 and set(widths[1:]) == {wave}, widths
        assert torch.equal(img, full), budget
    assert len(widths) > 6    # several waves an iteration


def test_xla_tie_scene_equals_pallas():
    """The tie check: two coincident boxes. On the primary wave the loop on
    K11a / K11b (``"xla"``) finds the chained sweeps' (K10a / K10b, the
    pallas tier) hits and occlusion bit for bit, ties included: both walk
    the entries in build order. The ``"xla"`` frame (the XLA body) is
    within 1e-6 of the pallas tier's fused frame, whose shading kernels
    may round a pixel an ulp apart."""
    r = Renderer(scenes.tie_scene(), "cpu")
    rs = r.render_static
    spp = rs.samples_per_pixel
    (px, py), act = integrator.tiled_pixels(rs, "cpu")
    px, py, act, s_row = integrator._folded_rows(px, py, act, spp)
    rays = raygen_packed_ref(r.camera_tensor(), s_row, px, py, spp, rs.width,
                             rs.height)
    o, d = tuple(rays[:3]), tuple(rays[3:])
    win = torch.where(act, RAY_TMAX, 0.0)
    ts = dataclasses.replace(r.tscene, traversal="xla")
    hit = trace.closest_hit_loop(ts, o, d, RAY_TMIN, win)
    chained = trace.closest_hit_wave(ts, o, d, RAY_TMIN, win,
                                     sweep=traverse.closest_sweep_ref)
    assert int(hit.valid.sum()) > 300    # the boxes' lanes
    for field in hit._fields:
        a, b = getattr(hit, field), getattr(chained, field)
        for x, y in zip(*((a, b) if field == "n" else ((a,), (b,)))):
            assert torch.equal(x, y), field
    occ = trace.any_hit_loop(ts, o, d, RAY_TMIN, win)
    assert occ.any() and torch.equal(occ, trace.any_hit_wave(
        ts, o, d, RAY_TMIN, win, sweep=traverse.anyhit_sweep_ref))
    frames = {}
    for trav in ("xla", "pallas"):
        stats = {}
        frames[trav] = render_frame(dataclasses.replace(r.tscene, traversal=trav),
                                    rs, r.camera_tensor(), stats=stats)
        assert stats["tier"] == trav
    assert frames["pallas"].std() > 1e-3
    assert (frames["xla"] - frames["pallas"]).abs().max() <= 1e-6


def _corners(mesh):
    p, t = mesh.positions, mesh.triangles.astype(np.int64)
    v0 = p[t[:, 0]]
    return tuple(np.ascontiguousarray(x, np.float32)
                 for x in (v0, p[t[:, 1]] - v0, p[t[:, 2]] - v0))


@pytest.mark.parametrize("name", ["teapot_standin", "cornell", "armadillo6"])
def test_native_trees_equal_raytpu_library(name):
    """The port's ``build_bvh`` (``g++ -O3 -mfma``) against the committed
    ``native/libraytpu_native.so`` that raytpu loads, at leaf size 12."""
    from raytpu.accel import native as jnative

    if not jnative.available():
        pytest.skip("the committed native library does not load here")
    if not native.host_has_fma():
        pytest.skip("no FMA on this host: the port's build raises here")
    mesh = {"teapot_standin": lambda: generate_highpoly(depth=4, radius=3.0),
            "cornell": scenes.cornell_mesh,
            "armadillo6": lambda: armadillo_standin(depth=6)}[name]()
    v0, e1, e2 = _corners(mesh)
    want = jnative.build_bvh(v0, e1, e2, leaf_size=12)
    got = native.build_bvh(v0, e1, e2, leaf_size=12)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)


@pytest.mark.parametrize("builder", ["library", "port"])
def test_tree_digest_is_raytpu_library_tree(builder):
    """``chip_smoke.TREE_DIGEST`` is the digest of the committed library's
    tree of the teapot stand-in (``generate_highpoly(depth=4, radius=3.0)``,
    leaf size 12), in ``chip_smoke.tree_digest``'s order; and
    ``chip_smoke.first_tree`` takes that tree out of a port scene whose
    first entry is the teapot stand-in (config2's, at a small size)."""
    import chip_smoke
    from raytpu.accel import native as jnative

    if builder == "library":
        if not jnative.available():
            pytest.skip("the committed native library does not load here")
        b = jnative.build_bvh(*_corners(generate_highpoly(depth=4, radius=3.0)),
                              leaf_size=12)
        tree = (b.aabb_min, b.aabb_max, b.tri_first, b.tri_count, b.miss, b.tri_order)
    else:
        if not native.host_has_fma():
            pytest.skip("no FMA on this host: the port's build raises here")
        ts = Renderer(scenes.config2_standin(16, width=32, height=32), "cpu").tscene
        assert len(ts.entry_rows) == 1
        tree = chip_smoke.first_tree(ts)
    assert chip_smoke.tree_digest(tree) == chip_smoke.TREE_DIGEST


def test_native_build_refuses_a_host_without_fma(monkeypatch):
    from raytpu_torch import _build

    monkeypatch.setattr(_build, "host_has_fma", lambda: False)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="FMA"):
        native.build_bvh(*_corners(scenes.cornell_mesh()), leaf_size=12)


if __name__ == "__main__":
    # the JAX side, in a process whose XLA_FLAGS the parent set
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    if sys.argv[1] == "walks":
        _jax_side(sys.argv[2])
    else:
        got, want = _xla_frames()
        np.savez(sys.argv[2], got=got, want=want)
