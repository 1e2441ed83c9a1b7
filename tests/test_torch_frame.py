"""The ported Whitted frame against raytpu's, on the three-material scene
(mirror ``spin``, diffuse ``static``, refractive ``orbit``, generated sky).
Both packages render one host scene (``tests/torch_twin.py``).

(a) Same rays, whole bounce loop: the XLA raygen's rays for the folded
    pixel and sample planes (``raytpu.integrator.primary_rays_soa``,
    packed) go into the port's ``render_packets`` through ``rays6=`` and
    into raytpu's bounce body ``_trace_sample`` (XLA body, default CPU
    traversal tier) with the same fold, mean and ``detile`` as its
    ``render_frame``. The cases (spp 2, 0 bounces), (1, 3) and (2, 63)
    cover spp {1, 2}, bounces {0, 3, 63} and both branches of the
    shadow-skip rule. The port's frame comes from its default fused loop
    (the shade and accumulate kernels' plain versions), compacted and,
    held to the same bar, at full width. The rays are fed to raytpu's bounce
    body and not regenerated inside ``render_frame`` because the shader
    hash is chaotic: XLA compiles the raygen inside the frame's jit with
    other rounding than the same ops run eagerly (measured 1e-2 apart on a
    64x48 wave), which would move every jitter sample.
(b) End to end: the port's ``Renderer.render_np()`` against raytpu's
    ``Renderer`` frame, SSIM > 0.98 (the goldens' bar).
(c) The readback: ``Renderer.step`` on the CPU hands back ``render()``'s
    frame itself, with no page-locked memory asked for.
(d) The kernel tiers: (a) at 32x32 against raytpu with ``traversal="pallas"``
    (the chained Pallas kernels, interpret mode), ``"perlane"`` and
    ``"mega"`` (the port's per-lane and consensus sweeps; raytpu's per-lane
    and megakernel tiers run only on a TPU, so off it raytpu renders the
    same function through its chained tier).

Tolerances. XLA:CPU contracts ``a*b + c`` into fused multiply-adds; the
port rounds every operation. The hits agree, but t differs by a few ulps
(see test_torch_traverse.py), and each specular bounce amplifies the
position error. Measured per-pixel max abs diff on this scene: 1.2e-7 at
0 bounces (spp 1 and 2), 8.6e-6 (spp 1) and 1.9e-5 (spp 2) at 3 bounces;
the 1e-5 bar holds for the first two cases. Long specular paths (TIR
inside the refractive mesh) are chaotic: at 63 bounces 15 of the 3072
pixels differ by more than 1e-4 (max 0.29), and raytpu against itself,
with every primary ray's x direction moved by one ulp, gives 16 such
pixels (max 0.39), 14 of them the same. So at 63 bounces the pixels whose
paths end within 4 bounces (the port's frame at cap 4 equals its frame at
cap 63 there; measured max diff 1.8e-5) are held to 1e-4, the rest must
stay under 3% of the frame, and the whole frame above SSIM 0.98.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import integrator as ji
from raytpu.ops.traverse_pallas import pack_rays
from raytpu.render import Renderer as JaxRenderer
from raytpu.utils.ssim import ssim
from raytpu_torch import scenes
from raytpu_torch.device_scene import from_raytpu
from raytpu_torch.integrator import (
    RenderStatic,
    detile,
    frame_tier,
    render_packets,
    tiled_pixels,
)
from raytpu_torch.render import Renderer
from tests.torch_twin import one_thread, twin

T_ANIM = 0.1  # the orbiting refractive mesh is in view


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_frame(scene, static, rs, o, d, s_idx, act):
    """raytpu's render_packets + detile, from given primary rays."""
    p = act.shape[0] // rs.samples_per_pixel
    k = act.shape[1]
    colors = ji._trace_sample(scene, static, rs, o, d, s_idx, act,
                              group=rs.sample_group)
    if rs.samples_per_pixel > 1:
        colors = tuple(c.reshape(p, rs.samples_per_pixel, k).mean(axis=1)
                       for c in colors)
    return ji.detile(colors, rs)


def _same_rays_frames(width, height, spp, bounces, scene_fn=scenes.mixed_scene,
                      short_cap=None, full=False, tier=None, **cfg):
    """(port frame, raytpu frame) from the same primary rays, the port's
    through its default fused loop; with ``short_cap``, also the port's
    frame at that bounce cap; with ``full``, also the port's frame through
    its full-width loop (``wavefront="full"``). ``tier``, if given, is the
    port's expected ``frame_tier``."""
    jscene, scene = twin(scene_fn(width, height, spp, bounces, **cfg))
    jr = JaxRenderer(jscene)
    jr.set_transforms(T_ANIM)
    rs_j = dataclasses.replace(jr.render_static, fused="off", wavefront="full")
    cam = jnp.asarray(jr.camera.basis())

    # the frame's tiles padded to a multiple of the chain kernels' PACK_N
    # (8), not to the 64-packet granule: the dropped packets are dead in
    # both packages and only cost interpret-mode time
    tiles = -(-width // 32) * -(-height // 32)
    n_pk = -(-tiles // 8) * 8
    (px, py), _, in_frame = ji._tiled_pixels(rs_j)
    px, py, in_frame = px[:n_pk], py[:n_pk], in_frame[:n_pk]
    p, k = px.shape
    s_row = jnp.tile(jnp.arange(spp, dtype=jnp.float32), (p,))
    pxs, pys = jnp.repeat(px, spp, axis=0), jnp.repeat(py, spp, axis=0)
    act = jnp.repeat(in_frame, spp, axis=0)
    s_idx = s_row[:, None] * jnp.ones((1, k), jnp.float32)
    o, d = ji.primary_rays_soa((pxs, pys), cam, s_idx, spp, width, height)
    rays6 = torch.from_numpy(np.array(pack_rays(o, d)).reshape(6, p * spp, k))

    want = np.asarray(_jax_frame(jr.device_scene, jr.static, rs_j, o, d,
                                 s_idx, act))

    ts = from_raytpu(jr.device_scene, jr.static, "cpu")
    assert tier is None or frame_tier(ts, n_pk * spp, k) == tier
    rs = RenderStatic.from_config(scene.config)
    (tpx, tpy), t_in = tiled_pixels(rs, "cpu")
    tpx, tpy, t_in = tpx[:n_pk], tpy[:n_pk], t_in[:n_pk]
    cam_t = torch.from_numpy(np.array(cam))

    def port(rs):
        colors = render_packets(ts, rs, cam_t, tpx, tpy, t_in, rays6=rays6)
        return detile(colors, rs).numpy()

    got = port(rs)
    if full:
        return got, want, port(dataclasses.replace(rs, wavefront="full"))
    if short_cap is None:
        return got, want
    return got, want, port(dataclasses.replace(rs, max_bounce_count=short_cap))


@pytest.mark.parametrize("spp,bounces", [(2, 0), (1, 3)])
def test_same_rays_frame_matches_raytpu(spp, bounces):
    got, want, full = _same_rays_frames(64, 48, spp, bounces, full=True)
    assert got.shape == want.shape == (48, 64, 3)
    assert want.std() > 0.05  # materials and sky all show
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(full, want, rtol=0, atol=1e-5)


def test_same_rays_deep_frame_matches_raytpu():
    got, want, capped = _same_rays_frames(64, 48, 2, 63, short_cap=4)
    short = (capped == got).all(axis=-1)   # every path ended by bounce 4
    assert 0.97 < short.mean() < 1.0, short.mean()  # deep paths do occur
    np.testing.assert_allclose(got[short], want[short], rtol=0, atol=1e-4)
    assert ssim(got, want) > 0.98


def test_renderer_frame_ssim_against_raytpu():
    jscene, scene = twin(scenes.mixed_scene(64, 48, 2, 3))
    r = Renderer(scene, "cpu")
    jr = JaxRenderer(jscene)
    for x in (r, jr):
        x.set_transforms(T_ANIM)
    got, want = r.render_np(), jr.render_np()
    assert np.isfinite(got).all()
    assert ssim(got, want) > 0.98


def test_step_on_the_cpu_returns_the_frame_unpinned(monkeypatch):
    """A CPU ``Renderer.step`` returns an f32 (H, W, 3) C-contiguous array
    equal bit for bit to ``render()`` of the same state; an earlier frame's
    array is unchanged after two later frames at other transforms; nothing
    asks for pinned memory."""
    pinned = []
    empty, pin = torch.empty, torch.Tensor.pin_memory

    def spy_empty(*args, pin_memory=False, **kw):
        pinned.append(pin_memory)
        return empty(*args, pin_memory=pin_memory, **kw)

    def spy_pin(t, *args):
        pinned.append(True)
        return pin(t, *args)

    monkeypatch.setattr(torch, "empty", spy_empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    r = Renderer(scenes.mixed_scene(32, 24, 1, 2), "cpu")
    with one_thread():
        first = r.step(T_ANIM)
        kept = first.copy()
        assert first.dtype == np.float32 and first.shape == (24, 32, 3)
        assert first.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(first, r.render().numpy())
        later = [r.step(t) for t in (0.3, 0.6)]
    assert True not in pinned
    np.testing.assert_array_equal(first, kept)
    for img in later:
        assert not np.shares_memory(img, first)
        assert not np.array_equal(img, first)   # the transforms show


@pytest.mark.parametrize("traversal", ["pallas", "perlane", "mega"])
def test_kernel_tier_frame_matches(traversal):
    got, want = _same_rays_frames(32, 32, 1, 2, scene_fn=scenes.two_box_scene,
                                  tier=traversal, traversal=traversal)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

