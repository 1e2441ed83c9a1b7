"""Frames of packets other than 32x32 tiles route as the JAX package routes
them: through the XLA body with the per-(instance, mesh) loop, on every
``traversal`` value.

raytpu's packed tiers (``_use_perlane``, ``_use_mega``, ``_all_pallas``,
``raytpu/ops/trace.py:550-630``) and its fused loop (``_use_fused``,
``raytpu/integrator.py:234``) refuse any packet width but ``PACKET_K``
(1024). Its body's loop then picks per mesh (``_use_pallas`` :619) the
one-mesh Pallas kernel under a forced ``"pallas"`` and the XLA packet walk
under every other value. The port's loop walks K11a/K11b, which compute
both. The tie scene (two coincident boxes) at ``tile=8``, 32x24, spp 1, 2
bounces, from the same primary rays, must equal raytpu's frame within 1e-5
per pixel with ``stats["tier"] == "xla"``.

raytpu renders no frame for a forced ``"pallas"`` at that width: its
one-mesh kernel asserts a packet of 1024 lanes (its register layout), so
the port's ``"pallas"`` frame is held to raytpu's ``"xla"`` frame, which
runs the same loop on the packet walk.

A scene with no BVH (``traversal="brute"``) takes the loop over the brute
tracers at every tile and on every traversal value, through the XLA body
(raytpu's ``has_bvh`` gates every packed tier). At 32x32 tiles every packed
tier takes the fused loop, the XLA body only "xla" and "brute".
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import integrator as ji
from raytpu.ops import trace as jt
from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import integrator, scenes
from raytpu_torch.device_scene import brute_scene
from raytpu_torch.integrator import (
    PACKET_K,
    _use_fused,
    detile,
    frame_packets,
    render_frame,
    render_packets,
    tiled_pixels,
)
from raytpu_torch.render import Renderer
from tests.torch_twin import one_thread, twin

TRAVERSALS = ("auto", "perlane", "mega", "hybrid", "pallas", "xla")
W, H, TILE = 32, 24, 8


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_frame(scene, static, rs, o, d, s_idx, act):
    """raytpu's bounce body and detile from given spp-1 primary rays."""
    colors = ji._trace_sample(scene, static, rs, o, d, s_idx, act,
                              group=rs.sample_group)
    return ji.detile(colors, rs)


@pytest.fixture(scope="module")
def tie8():
    """Both packages' tie scene at tile 8, the primary rays of raytpu's XLA
    raygen, and raytpu's ``"xla"`` frame from them."""
    jscene, scene = twin(scenes.tie_scene(W, H, samples_per_pixel=1))
    jr = JaxRenderer(jscene)
    r = Renderer(scene, "cpu")
    rs_j = dataclasses.replace(jr.render_static, tile=TILE, fused="on")
    (px, py), _, act = ji._tiled_pixels(rs_j)
    s_idx = jnp.zeros(px.shape, jnp.float32)
    o, d = ji.primary_rays_soa((px, py), jnp.asarray(jr.camera.basis()), s_idx,
                               1, W, H)
    rays = (o, d, s_idx, act)
    want = np.asarray(_jax_frame(jr.device_scene, dataclasses.replace(
        jr.static, traversal="xla"), rs_j, *rays))
    rays6 = torch.from_numpy(np.stack([np.asarray(x) for x in (*o, *d)]))
    return jr, r, rs_j, rays, want, rays6


def test_raytpu_routes_every_value_through_the_loop(tie8):
    """At 64-lane packets raytpu's fused loop and packed tiers refuse every
    value, and its loop takes the one-mesh Pallas kernel only under
    ``"pallas"``, where that kernel asserts 1024 lanes."""
    jr, _, rs_j, rays, _, _ = tie8
    p, k = rays[3].shape
    assert k == TILE * TILE != PACKET_K
    for trav in TRAVERSALS:
        st = dataclasses.replace(jr.static, traversal=trav)
        assert not ji._use_fused(st, rs_j, p, k)
        assert not jt._use_perlane(st, p, k, "primary")
        assert not jt._use_perlane(st, p, k, "loop")
        assert not jt._use_mega(st, p, k) and not jt._all_pallas(st, k)
        for _, mesh in st.traversal_list:
            assert jt._use_pallas(st, mesh, k) == (trav == "pallas")
    with pytest.raises(AssertionError, match="K=1024"):
        _jax_frame(jr.device_scene, dataclasses.replace(jr.static, traversal="pallas"),
                   rs_j, *rays)


@pytest.mark.parametrize("traversal", TRAVERSALS)
def test_tile8_frame_is_the_loop_and_matches_raytpu(tie8, traversal):
    _, r, _, _, want, rays6 = tie8
    rs = dataclasses.replace(r.render_static, tile=TILE)
    ts = dataclasses.replace(r.tscene, traversal=traversal)
    (px, py), in_frame = tiled_pixels(rs, "cpu")
    assert not _use_fused(ts, *px.shape)
    stats = {}
    with one_thread():
        got = detile(render_packets(ts, rs, r.camera_tensor(), px, py, in_frame,
                                    rays6=rays6, stats=stats), rs).numpy()
    assert stats["tier"] == "xla"
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("traversal", TRAVERSALS)
def test_tile32_frame_keeps_its_tier(tie8, traversal, monkeypatch):
    """The same scene at 32x32 tiles keeps the tier each value names, and
    every packed tier takes the fused loop: only "xla" reaches the XLA
    body."""
    r = tie8[1]
    ts = dataclasses.replace(r.tscene, traversal=traversal)
    want = {"auto": r.tscene.auto_tier}.get(traversal, traversal)
    rs = r.render_static
    (px, _), _ = tiled_pixels(rs, "cpu")
    assert px.shape[1] == PACKET_K
    assert _use_fused(ts, *px.shape) == (traversal != "xla")
    loops = []
    for name in ("_trace_sample", "_trace_sample_fused"):
        def spy(*args, _real=getattr(integrator, name), _name=name, **kwargs):
            loops.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(integrator, name, spy)
    stats = {}
    with one_thread():
        img = render_frame(ts, rs, r.camera_tensor(), stats=stats)
    assert stats["tier"] == want and img.std() > 0.05
    assert loops == ["_trace_sample" if traversal == "xla"
                     else "_trace_sample_fused"]


def test_brute_scene_takes_the_brute_loop(tie8):
    """The tie scene without its BVH: the brute loop at tile 8 from the same
    rays, within 1e-5 of raytpu's frame, and at 32x32 tiles too, on every
    traversal value."""
    _, r, _, _, want, rays6 = tie8
    ts = brute_scene(r.tscene)
    rs = dataclasses.replace(r.render_static, tile=TILE)
    (px, py), in_frame = tiled_pixels(rs, "cpu")
    stats = {}
    with one_thread():
        got = detile(render_packets(ts, rs, r.camera_tensor(), px, py, in_frame,
                                    rays6=rays6, stats=stats), rs).numpy()
    assert stats["tier"] == "brute"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for trav in TRAVERSALS + ("brute",):
        tsb = dataclasses.replace(ts, traversal=trav)
        assert not _use_fused(tsb, frame_packets(r.render_static), PACKET_K)
        stats = {}
        with one_thread():
            img = render_frame(tsb, r.render_static, r.camera_tensor(),
                               stats=stats)
        assert stats["tier"] == "brute" and img.std() > 0.05
