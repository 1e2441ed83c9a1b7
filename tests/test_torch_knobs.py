"""The ``RenderConfig`` values the JAX package renders with no BVH, with
chunked trees and at full width, held against raytpu on the CPU:

* the brute tracers' plain versions (``brute_closest_ref``,
  ``brute_anyhit_ref``) against ``raytpu.ops.intersect.brute_closest`` /
  ``brute_anyhit`` on seeded triangle soups with dead lanes and duplicated
  triangles (exact ties): prim exact, t, u and v within 4 f32 ulps,
  occlusion flags exact;
* the port's chunked trees (``chunk_tris=2048`` on
  ``generate_highpoly(depth=5)``, 10 entries) against raytpu's
  ``attach_bvh``, bit for bit;
* frames of ``mixed_scene(64, 48, spp 2, 3 bounces)`` under each value
  against raytpu's frame from the same primary rays, within 1e-5, and
  against the port's default frame of the same rays, bit for bit: the
  brute scenes against the XLA body's frame on the scene's BVH
  (``traversal="xla"``, the body's other loop), the chunked trees and the
  full-width loop against the fused loop's default frame; the scene has
  no exact ties;
* a brute frame and a chunked frame over 2 CPU slots, equal to one
  device's.

raytpu's side renders in a child process whose XLA:CPU has no fused
multiply-add (``--xla_cpu_max_isa=AVX``, as in ``test_torch_traverse.py``):
the port rounds every operation once. raytpu's frames are its brute
program's, unrolled for the full-width frame (its ``bounce_unroll``
computes the loop's frame): every tier of raytpu computes the same hits
and the scene has no exact ties, and its chunks change no hit, while its
BVH programs take about 40 s each to compile here.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import integrator as ji
from raytpu.accel import attach_bvh as jax_attach_bvh
from raytpu.device_scene import build_device_scene as jax_device_scene
from raytpu.ops import intersect as jint
from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import integrator, scenes
from raytpu_torch.accel import attach_bvh
from raytpu_torch.device_scene import build_device_scene, pack_tris
from raytpu_torch.integrator import (
    _use_fused,
    detile,
    render_packets,
    tiled_pixels,
)
from raytpu_torch.io.genmesh import generate_highpoly
from raytpu_torch.ops import intersect
from raytpu_torch.render import Renderer
from raytpu_torch.scene import load_scene
from tests.torch_twin import one_thread, twin

NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent
T_ANIM = 0.1
TMIN = 1e-3
SEEDS = (0, 1, 2)
# each value: its config knobs, the port's default frame it is held to bit
# for bit ("body": the XLA body on the scene's BVH; "fused": the fused
# loop), and raytpu's program whose frame it is held to within 1e-5
KNOBS = {
    "traversal=brute": (dict(traversal="brute"), "body", "brute"),
    "bvh_builder=brute": (dict(bvh_builder="brute"), "body", "brute"),
    "chunk_tris=64": (dict(chunk_tris=64), "fused", "brute"),
    "wavefront=full": (dict(wavefront="full"), "fused", "unroll"),
}
# raytpu's programs, each its scene's config knobs and its render statics:
# its brute loop, and its brute loop unrolled at full width
JAX_PROGRAMS = {"brute": (dict(traversal="brute"), {}),
                "unroll": (dict(traversal="brute", wavefront="full"),
                           dict(bounce_unroll=True))}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _soup(seed: int):
    """Seeded triangles (T, 3) x3 and rays: 700 triangles around the
    origin, the last 40 copies of others (every ray that hits one hits its
    copy at exactly the same t), 3000 rays from a shell aimed inside, every
    seventh lane dead and the windows varied."""
    rng = np.random.default_rng(seed)
    n = 660
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.8, size=(n, 3)).astype(np.float32)
    dup = rng.choice(n, 40, replace=False)
    v0, e1, e2 = (np.concatenate([x, x[dup]]) for x in (v0, e1, e2))
    r = 3000
    u = rng.normal(size=(r, 3))
    o = (u / np.linalg.norm(u, axis=1, keepdims=True) * 8.0).astype(np.float32)
    d = (rng.uniform(-2, 2, (r, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(4.0, 14.0, r).astype(np.float32)
    tmax[::7] = 0.0
    return v0, e1, e2, o, d, tmax


def _port_soup(seed: int):
    v0, e1, e2, o, d, tmax = _soup(seed)
    rays = torch.from_numpy(np.ascontiguousarray(np.concatenate([o.T, d.T])))
    tris = pack_tris(*(torch.from_numpy(x) for x in (v0, e1, e2)))
    return rays, torch.from_numpy(tmax), tris


def _jax_brute(seed: int) -> dict:
    v0, e1, e2, o, d, tmax = _soup(seed)
    t, prim, u, v = jint.brute_closest(o, d, v0, e1, e2, TMIN, tmax)
    occ = jint.brute_anyhit(o, d, v0, e1, e2, TMIN, tmax)
    return {f"brute{seed}_{k}": np.asarray(x)
            for k, x in zip(("t", "prim", "u", "v", "occ"), (t, prim, u, v, occ))}


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_wave(scene, static, rs, o, d, s_idx, act):
    """raytpu's bounce body over one folded wave from given primary rays."""
    return ji._trace_sample(scene, static, rs, o, d, s_idx, act,
                            group=rs.sample_group)


def _knob_frames() -> dict:
    """raytpu's folded frame of each of its programs, and per knob the
    port's frame and its default frame, all from raytpu's primary rays."""
    out, rays = {}, None
    for prog, (knob, statics) in JAX_PROGRAMS.items():
        jr = JaxRenderer(twin(scenes.mixed_scene(64, 48, 2, 3, **knob))[0])
        jr.set_transforms(T_ANIM)
        rs_j = dataclasses.replace(jr.render_static, fused="off", **statics)
        cam = jnp.asarray(jr.camera.basis())
        (px, py), _, act = ji._tiled_pixels(rs_j)
        spp, (p, k) = 2, px.shape
        s_idx = jnp.tile(jnp.arange(spp, dtype=jnp.float32), (p,))[:, None] \
            * jnp.ones((1, k), jnp.float32)
        o, d = ji.primary_rays_soa((jnp.repeat(px, spp, axis=0),
                                    jnp.repeat(py, spp, axis=0)), cam, s_idx,
                                   spp, 64, 48)
        c = _jax_wave(jr.device_scene, jr.static, rs_j, o, d, s_idx,
                      jnp.repeat(act, spp, axis=0))
        out[f"jax_{prog}"] = np.asarray(ji.detile(
            tuple(x.reshape(p, spp, k).mean(axis=1) for x in c), rs_j))
        rays = (torch.from_numpy(np.stack([np.asarray(x, np.float32)
                                           for x in (*o, *d)])),
                torch.from_numpy(np.array(cam)))
    rays6, cam_t = rays
    base = Renderer(twin(scenes.mixed_scene(64, 48, 2, 3))[1], "cpu")
    base.set_transforms(T_ANIM)
    (tpx, tpy), t_in = tiled_pixels(base.render_static, "cpu")

    def frame(ts, rs):
        return detile(render_packets(ts, rs, cam_t, tpx, tpy, t_in,
                                     rays6=rays6), rs).numpy()

    defaults = {
        "body": frame(dataclasses.replace(base.tscene, traversal="xla"),
                      base.render_static),
        "fused": frame(base.tscene, base.render_static)}
    for name, (knob, ref, _) in KNOBS.items():
        r = Renderer(twin(scenes.mixed_scene(64, 48, 2, 3, **knob))[1], "cpu")
        r.set_transforms(T_ANIM)
        out[f"{name}_got"] = frame(r.tscene, r.render_static)
        out[f"{name}_default"] = defaults[ref]
    return out


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """raytpu's brute results and every frame pair, computed in one child
    process without FMA."""
    out = tmp_path_factory.mktemp("knobs") / "knobs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_brute_plain_matches_raytpu(child, seed):
    rays, tmax, tris = _port_soup(seed)
    t, prim, u, v = intersect.brute_closest(rays, tmax, tris, TMIN)
    occ = intersect.brute_anyhit(rays, tmax, tris, TMIN)
    want = {k: child[f"brute{seed}_{k}"] for k in ("t", "prim", "u", "v", "occ")}
    np.testing.assert_array_equal(prim.numpy(), want["prim"])
    hit = want["prim"] >= 0
    assert 200 < hit.sum() < 2900 and not hit[::7].any()
    np.testing.assert_array_equal(t.numpy()[~hit], want["t"][~hit])
    for got, key in ((t, "t"), (u, "u"), (v, "v")):
        assert _ulps(got.numpy()[hit], want[key][hit]).max() <= 4, key
    np.testing.assert_array_equal(occ.numpy(), want["occ"])
    assert occ.numpy()[hit].all()


@pytest.mark.parametrize("seed", SEEDS)
def test_brute_keeps_the_lowest_of_tied_triangles(seed):
    """The block scan at any block size equals a scan of one triangle at a
    time with strict ``t < best_t`` (the kernel's order), bit for bit; the
    soup's copies make exact ties, which keep the lower index; the any-hit
    at any block size equals its scan of one triangle at a time."""
    rays, tmax, tris = _port_soup(seed)
    ref = intersect.brute_closest_ref(rays, tmax, tris, TMIN, block=1)
    n = tris.shape[0]
    for block in (7, 64, 512, 4096):
        got = intersect.brute_closest_ref(rays, tmax, tris, TMIN, block=block)
        for a, b in zip(got, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    prim = ref[1]
    copied = (tris[:n - 40, None] == tris[None, n - 40:]).all(dim=2).any(dim=1)
    assert copied.sum() == 40
    assert copied[prim.clamp_min(0).long()][prim >= 0].sum() > 10
    assert not (prim >= n - 40).any()   # a copy never wins its tie
    occ = intersect.brute_anyhit_ref(rays, tmax, tris, TMIN, block=64)
    assert torch.equal(occ, intersect.brute_anyhit_ref(rays, tmax, tris, TMIN,
                                                       block=1))
    assert occ.any() and not occ.all()


def test_brute_wrappers_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal path is CPU-only")
    rays, tmax, tris = (x.to("meta") for x in _port_soup(0))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        intersect.brute_closest(rays, tmax, tris, TMIN)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        intersect.brute_anyhit(rays, tmax, tris, TMIN)


def test_chunked_trees_equal_raytpu():
    """``chunk_tris=2048`` on the 20,480-triangle highpoly (with a 12-
    triangle box of one chunk beside it): the port's concatenated trees,
    slot order, prims, entries and traversal list equal raytpu's
    ``attach_bvh``'s bit for bit, 10 + 1 entries."""
    jscene, scene = twin(scenes.mixed_scene(32, 32, 1, 1, depth=5,
                                            chunk_tris=2048))
    dev, static = jax_device_scene(jscene)
    dev, static = jax_attach_bvh(dev, static, jscene)
    ts = attach_bvh(build_device_scene(scene, "cpu"), scene, leaf_size=12)
    assert ts.traversal_list == tuple(static.traversal_list)
    assert len(ts.traversal_list) == 10 + 1 + 10
    for name in ("bvh_aabb_min", "bvh_aabb_max", "bvh_tri_first",
                 "bvh_tri_count", "bvh_miss", "bvh_tri_v0", "bvh_tri_e1",
                 "bvh_tri_e2", "bvh_tri_prim", "bvh_tri_n_soa"):
        want = np.asarray(getattr(dev, name))
        got = getattr(ts, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=name)
    rows = [(inst, int(dev.materials[inst]), *static.mesh_node_ranges[m],
             static.mesh_bvh_tri_ranges[m][0])
            for inst, m in static.traversal_list]
    assert list(ts.entry_rows) == rows
    # chunk_tris=0: one tree a mesh
    plain = attach_bvh(build_device_scene(scene, "cpu"),
                       dataclasses.replace(scene, config=scene.config.replace(
                           chunk_tris=0)), leaf_size=12)
    assert len(plain.traversal_list) == 3


@pytest.mark.parametrize("name", KNOBS)
def test_knob_frame_matches_raytpu(child, name):
    got, want = child[f"{name}_got"], child[f"jax_{KNOBS[name][2]}"]
    assert got.shape == want.shape == (48, 64, 3) and want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, child[f"{name}_default"])


def test_knob_routing():
    """Brute scenes take the brute loop on every traversal value and tile;
    chunked trees keep the fused loop and their tier, and a full-width
    frame the fused loop."""
    scene = scenes.mixed_scene(64, 48, 2, 3)
    r = Renderer(scene, "cpu")
    rb = Renderer(scenes.mixed_scene(64, 48, 2, 3, traversal="brute"), "cpu")
    assert not rb.tscene.has_bvh and rb.tscene.packed_nodes is None
    assert rb.tscene.entry_rows == tuple(
        (i, int(r.tscene.materials[i]), 0, c, s) for i, (s, c) in
        enumerate(rb.tscene.mesh_prim_ranges))
    for trav in integrator._TRAVERSALS:
        ts = dataclasses.replace(rb.tscene, traversal=trav)
        for k in (64, 1024):
            assert integrator.frame_tier(ts, 64, k) == "brute"
            assert not _use_fused(ts, 64, k)
    # a scene that has a BVH walks it under "brute" (raytpu/ops/trace.py:290)
    assert integrator.frame_tier(dataclasses.replace(r.tscene, traversal="brute"),
                                 64, 1024) == "xla"
    rc = Renderer(scenes.mixed_scene(64, 48, 2, 3, chunk_tris=64), "cpu")
    assert len(rc.tscene.entry_rows) > len(r.tscene.entry_rows)
    assert _use_fused(rc.tscene, 64, 1024)
    assert integrator.frame_tier(rc.tscene, 64, 1024) \
        == integrator.frame_tier(r.tscene, 64, 1024) == "mega"
    r.render_static = dataclasses.replace(r.render_static, wavefront="full")
    r.set_transforms(T_ANIM)
    stats = {}
    r.render(stats=stats)
    assert stats["tier"] == "mega"
    # the full-width loop reads the live windows once a bounce, at most,
    # and never the lit lanes (spp 2 and 3 bounces always sweep)
    assert 0 < stats["host_syncs"] <= r.render_static.max_bounce_count + 1


@pytest.mark.parametrize("knob", [dict(traversal="brute"), dict(chunk_tris=64)],
                         ids=("brute", "chunked"))
def test_sharded_knob_frame_equals_single(knob):
    single = Renderer(scenes.mixed_scene(64, 48, 2, 3, **knob), "cpu")
    sharded = Renderer(scenes.mixed_scene(64, 48, 2, 3, devices=2, **knob), "cpu")
    for r in (single, sharded):
        r.set_transforms(T_ANIM)
    stats = {}
    img = sharded.render(stats=stats)
    assert len(stats["slots"]) == 2
    assert torch.equal(img, single.render())


def test_new_values_accepted_and_rendered():
    """A brute Renderer validates its scene and renders within 1e-5 of the
    default frame; a scene of repeated meshes keeps a prim range each."""
    base = Renderer(scenes.two_box_scene(32, 32, 2, 2), "cpu").render()
    r = Renderer(scenes.two_box_scene(32, 32, 2, 2, traversal="brute",
                                      validation=True), "cpu")
    assert r.render_static.validation and not r.tscene.has_bvh
    assert (r.render() - base).abs().max() <= 1e-5
    s = load_scene(scenes.two_box_scene().config,
                   meshes=[generate_highpoly(depth=1)] * 2)
    assert Renderer(s, "cpu").tscene.mesh_prim_ranges == ((0, 80), (80, 80))


if __name__ == "__main__":
    # raytpu's side, in a process whose XLA_FLAGS the parent set
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    out = {}
    for seed in SEEDS:
        out.update(_jax_brute(seed))
    np.savez(sys.argv[1], **out, **_knob_frames())
