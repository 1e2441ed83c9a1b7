"""The render options of the PyTorch port against raytpu's, on the CPU:
the unfolded spp loop (``RenderStatic(fold_spp=False)``), ray chunks
(``ray_chunk``), the "nearest" and "bilinear2x" sky filters (the single-tap
sampler and the 2x prefiltered map), and validation (``check_scene``,
``check_frame`` and the bounce loops' guard).

The frames against raytpu's come from the same primary rays: raytpu's
eager primary rays go into raytpu's bounce body and into the port's
``render_packets`` (``rays6=``) or, for the chunked frame, into the port's
``render_frame`` through a raygen that hands them over
(``integrator.kernels(raygen=...)``). They render in a child process whose
XLA:CPU has no fused multiply-add (``--xla_cpu_max_isa=AVX``, as in
``test_torch_consensus.py``): with FMA, three bounces at spp 2 put the
unfolded frame 1.9e-5 from raytpu's on 5 of 9,216 values, and the tile-8
chunked frame 3.5e-5; without it, 0 and 4.2e-7.
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
from raytpu.device_scene import build_device_scene as jax_device_scene
from raytpu.ops import sky as jsky
from raytpu.ops import vec3 as jv3
from raytpu.render import Renderer as JaxRenderer
from raytpu.utils.ssim import ssim
from raytpu_torch import integrator, scenes
from raytpu_torch.device_scene import from_raytpu, pack_skybox, pack_skybox_2x
from raytpu_torch.integrator import (
    RenderStatic,
    detile,
    render_frame,
    render_packets,
    tiled_pixels,
)
from raytpu_torch.ops import sky
from raytpu_torch.render import Renderer
from raytpu_torch.utils import log, validation
from raytpu_torch.utils.log import RaytpuError
from tests.torch_twin import one_thread, raytpu_twin

T_ANIM = 0.1
NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent
FILTERS = ("nearest", "bilinear2x")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_wave(scene, static, rs, o, d, s_idx, act):
    """raytpu's bounce body over one wave from given primary rays."""
    return ji._trace_sample(scene, static, rs, o, d, s_idx, act)


def _jax_rays(cam, px, py, s_idx, spp, width, height):
    """raytpu's eager primary rays -> (o, d) Vec3s and the (6, P, K) f32
    array of them."""
    o, d = ji.primary_rays_soa((px, py), cam, s_idx, spp, width, height)
    return o, d, np.stack([np.asarray(x, np.float32) for x in (*o, *d)])


def _setup(scene, tile=32):
    """raytpu's Renderer (posed), its XLA-body render statics at ``tile``,
    the camera, the tiled pixels, and the port's scene carried across."""
    jr = JaxRenderer(raytpu_twin(scene))
    jr.set_transforms(T_ANIM)
    rs_j = dataclasses.replace(jr.render_static, fused="off",
                               wavefront="full", tile=tile)
    cam = jnp.asarray(jr.camera.basis())
    (px, py), _, in_frame = ji._tiled_pixels(rs_j)
    ts = from_raytpu(jr.device_scene, jr.static, "cpu")
    rs = dataclasses.replace(RenderStatic.from_config(scene.config), tile=tile)
    return jr, rs_j, cam, (px, py, in_frame), ts, rs


def _unfolded_frames():
    """mixed_scene(64, 48, spp=2, bounces=3): raytpu's unfolded loop (one
    wave a sample, summed, scaled by 1/spp) and the port's unfolded and
    folded frames, all from the same rays per sample; then both packages'
    Renderer frames with ``fold_spp=False``."""
    scene = scenes.mixed_scene(64, 48, 2, 3)
    jr, rs_j, cam, (px, py, act), ts, rs = _setup(scene)
    spp, (p, k) = 2, px.shape
    acc, waves = None, []
    for i in range(spp):
        o, d, arr = _jax_rays(cam, px, py, jnp.float32(i), spp, 64, 48)
        c = _jax_wave(jr.device_scene, jr.static, rs_j, o, d, jnp.float32(i), act)
        acc = c if acc is None else jv3.add(acc, c)
        waves.append(arr)
    want = np.asarray(ji.detile(jv3.scale(1.0 / spp, acc), rs_j))
    rays6 = torch.from_numpy(np.stack(waves, axis=2).reshape(6, p * spp, k))
    (tpx, tpy), t_in = tiled_pixels(rs, "cpu")
    cam_t = torch.from_numpy(np.array(cam))

    def port(rs_):
        return detile(render_packets(ts, rs_, cam_t, tpx, tpy, t_in,
                                     rays6=rays6), rs_).numpy()

    got = port(dataclasses.replace(rs, fold_spp=False))
    folded = port(rs)
    jr.render_static = dataclasses.replace(jr.render_static, fold_spp=False)
    r = Renderer(scene, "cpu")
    r.render_static = dataclasses.replace(r.render_static, fold_spp=False)
    r.set_transforms(T_ANIM)
    return dict(unfold_got=got, unfold_want=want, unfold_folded=folded,
                unfold_e2e_got=r.render_np(), unfold_e2e_want=jr.render_np())


def _chunked_frames():
    """mixed_scene(128, 96, spp 1, bounces 2) at tile 8 (192 packets of 64
    lanes) with ray_chunk=4096 (3 chunks of 64 packets): raytpu's chunk loop
    (``lax.map`` of ``render_packets`` over the chunks, its bounce body on
    each chunk's rays) and the port's chunked ``render_frame``, whose raygen
    hands over raytpu's rays."""
    scene = scenes.mixed_scene(128, 96, 1, 2, ray_chunk=4096)
    jr, rs_j, cam, (px, py, act), ts, rs = _setup(scene, tile=8)
    o, d, _ = _jax_rays(cam, px, py, jnp.float32(0), 1, 128, 96)
    cols = [_jax_wave(jr.device_scene, jr.static, rs_j,
                      tuple(x[s:s + 64] for x in o), tuple(x[s:s + 64] for x in d),
                      jnp.float32(0), act[s:s + 64])
            for s in range(0, px.shape[0], 64)]
    want = np.asarray(ji.detile(tuple(jnp.concatenate([c[i] for c in cols])
                                      for i in range(3)), rs_j))

    def raygen(camera, s_row, px_, py_, spp, width, height):
        s_idx = jnp.asarray(s_row.numpy())[:, None] * jnp.ones((1, px_.shape[1]))
        return torch.from_numpy(_jax_rays(cam, jnp.asarray(px_.numpy()),
                                          jnp.asarray(py_.numpy()), s_idx,
                                          spp, width, height)[2])

    with integrator.kernels(raygen=raygen):
        got = render_frame(ts, rs, torch.from_numpy(np.array(cam))).numpy()
    return dict(chunk_got=got, chunk_want=want)


def _filter_frames():
    """mixed_scene(64, 48, spp 2, bounces 3) with each new filter: raytpu's
    folded frame and the port's from the same rays."""
    out = {}
    for f in FILTERS:
        scene = scenes.mixed_scene(64, 48, 2, 3, skybox_filter=f)
        jr, rs_j, cam, (px, py, act), ts, rs = _setup(scene)
        spp, (p, k) = 2, px.shape
        s_idx = jnp.tile(jnp.arange(spp, dtype=jnp.float32), (p,))[:, None] \
            * jnp.ones((1, k), jnp.float32)
        o, d, arr = _jax_rays(cam, jnp.repeat(px, spp, axis=0),
                              jnp.repeat(py, spp, axis=0), s_idx, spp, 64, 48)
        c = _jax_wave(jr.device_scene, jr.static, rs_j, o, d, s_idx,
                      jnp.repeat(act, spp, axis=0))
        out[f"{f}_want"] = np.asarray(ji.detile(
            tuple(x.reshape(p, spp, k).mean(axis=1) for x in c), rs_j))
        (tpx, tpy), t_in = tiled_pixels(rs, "cpu")
        out[f"{f}_got"] = detile(render_packets(
            ts, rs, torch.from_numpy(np.array(cam)), tpx, tpy, t_in,
            rays6=torch.from_numpy(arr)), rs).numpy()
    return out


@pytest.fixture(scope="module")
def child_frames(tmp_path_factory):
    """Every frame pair of the raytpu comparisons, rendered in one child
    process without FMA."""
    out = tmp_path_factory.mktemp("options") / "frames.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def test_unfolded_frame_matches_raytpu(child_frames):
    got, want = child_frames["unfold_got"], child_frames["unfold_want"]
    assert got.shape == want.shape == (48, 64, 3) and want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, child_frames["unfold_folded"], rtol=0,
                               atol=1e-6)
    e2e_got, e2e_want = child_frames["unfold_e2e_got"], child_frames["unfold_e2e_want"]
    assert np.isfinite(e2e_got).all()
    assert ssim(e2e_got, e2e_want) > 0.98


def test_chunked_frame_matches_raytpu(child_frames):
    got, want = child_frames["chunk_got"], child_frames["chunk_want"]
    assert got.shape == want.shape == (96, 128, 3) and want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("skybox_filter", FILTERS)
def test_filter_frame_matches_raytpu(child_frames, skybox_filter):
    """SSIM > 0.98, and at most 0.5% of the pixels over 1e-5: a one-ulp
    drift of a bounced direction can move a single tap to the next texel."""
    got = child_frames[f"{skybox_filter}_got"]
    want = child_frames[f"{skybox_filter}_want"]
    assert got.shape == want.shape == (48, 64, 3) and want.std() > 0.05
    over = int((np.abs(got - want) > 1e-5).any(axis=-1).sum())
    print(f"{skybox_filter}: {over} of {got.shape[0] * got.shape[1]} pixels "
          f"over 1e-5, max {np.abs(got - want).max():.3g}")
    assert over <= 0.005 * got.shape[0] * got.shape[1]
    assert ssim(got, want) > 0.98


def test_unfolded_frame_equals_folded_frame():
    """The port's own raygen: the unfolded frame within 1e-6 of the folded
    one, with the stats summed over the sample waves and the tier of one."""
    r = Renderer(scenes.mixed_scene(64, 48, 2, 3), "cpu")
    r.set_transforms(T_ANIM)
    folded, unfolded = {}, {}
    a = r.render(stats=folded).numpy()
    r.render_static = dataclasses.replace(r.render_static, fold_spp=False)
    b = r.render(stats=unfolded).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert unfolded["tier"] == integrator.frame_tier(r.tscene, 64, 1024)
    assert int(unfolded["closest_rays"]) == int(folded["closest_rays"])
    assert unfolded["host_syncs"] > folded["host_syncs"]


def test_chunked_frame_equals_whole_frame(monkeypatch):
    """128x96 at tile 8 with ray_chunk=4096: three chunks of 64 packets,
    within 1e-6 of the whole frame, the stats summed over the chunks."""
    r = Renderer(scenes.mixed_scene(128, 96, 1, 2, ray_chunk=4096), "cpu")
    r.set_transforms(T_ANIM)
    rs = dataclasses.replace(r.render_static, tile=8)
    calls = []
    real = integrator.render_packets

    def counted(ts, rs_, camera, px, *args, **kw):
        calls.append(px.shape)
        return real(ts, rs_, camera, px, *args, **kw)

    cam = r.camera_tensor()
    whole = {}
    want = render_frame(r.tscene, dataclasses.replace(rs, ray_chunk=0), cam,
                        stats=whole).numpy()
    monkeypatch.setattr(integrator, "render_packets", counted)
    chunked = {}
    got = render_frame(r.tscene, rs, cam, stats=chunked).numpy()
    assert calls == [(64, 64)] * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert int(chunked["closest_rays"]) == int(whole["closest_rays"])
    assert chunked["tier"] == whole["tier"] == "xla"


def _sky_dirs(n: int, seed: int) -> np.ndarray:
    """Seeded directions, the last third on the face edges and corners
    (|x| = |y|, |y| = |z|, ...) and on the axes."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    m = n // 3
    e = rng.normal(size=(m, 3)).astype(np.float32)
    e[:, 1] = e[:, 0] * rng.choice([-1.0, 1.0], m).astype(np.float32)
    e[m // 2:, 2] = e[m // 2:, 0]
    e[: m // 8] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, m // 8)] \
        * rng.choice([-1.0, 1.0], (m // 8, 1)).astype(np.float32)
    d[-m:] = e
    return d


@pytest.mark.parametrize("h,w", [(16, 16), (5, 7)])
def test_nearest_sampler_matches_raytpu(h, w):
    sky_np = np.random.default_rng(h * w).random((6, h, w, 3), np.float32)
    words, _ = pack_skybox(sky_np)
    d = _sky_dirs(3000, seed=h)
    want = jsky.sample_cubemap_u32_nearest(
        jnp.asarray(words.view(np.uint32)), h, w,
        tuple(jnp.asarray(d[:, c]) for c in range(3)))
    got = sky.sample_cubemap_u32_nearest(
        torch.from_numpy(words), h, w,
        tuple(torch.from_numpy(np.ascontiguousarray(d[:, c])) for c in range(3)))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_skybox_2x_matches_raytpu():
    """The 2x map's words equal raytpu's; the Renderer builds it only for
    the "bilinear2x" filter."""
    scene = scenes.mixed_scene(32, 32, 1, 1, sky_size=12)
    dev, _ = jax_device_scene(raytpu_twin(scene))
    want = np.asarray(dev.skybox_u32_2x).view(np.int32)
    np.testing.assert_array_equal(pack_skybox_2x(scene.skybox), want)
    ts = Renderer(scenes.mixed_scene(32, 32, 1, 1, sky_size=12,
                                     skybox_filter="bilinear2x"), "cpu").tscene
    np.testing.assert_array_equal(ts.skybox_u32_2x.numpy(), want)
    assert Renderer(scene, "cpu").tscene.skybox_u32_2x is None


@pytest.mark.parametrize("knob", [
    dict(skybox_filter="nearest"), dict(skybox_filter="bilinear2x"),
    dict(ray_chunk=1024), dict(validation=True), dict(bvh_builder="sah"),
    dict(bvh_builder="median"), dict(bvh_builder="lbvh"),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_new_config_values_render(knob):
    r = Renderer(scenes.two_box_scene(64, 64, 2, 2, **knob), "cpu")
    img = r.render_np()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all() and img.std() > 0.01


def test_check_scene_names_a_nan_light():
    r = Renderer(scenes.two_box_scene(32, 32, validation=True), "cpu")
    ts = dataclasses.replace(r.tscene, light_pos=torch.tensor(
        [np.nan, 5.0, 5.0]))
    with pytest.raises(RaytpuError, match="light_pos"):
        validation.check_scene(ts)


def test_check_frame_raises_on_nan():
    with pytest.raises(RaytpuError, match="non-finite"):
        validation.check_frame(torch.full((4, 4, 3), float("nan")))
    validation.check_frame(np.zeros((4, 4, 3), np.float32))


def test_guard_reports_a_nan_camera(monkeypatch):
    """validation=True: a clean frame reports nothing; a NaN camera makes
    the guard report through log.error (raytpu's test_integrator.py:216)."""
    errors = []
    monkeypatch.setattr(log, "error", errors.append)
    r = Renderer(scenes.two_box_scene(32, 32, 1, 0), "cpu")
    rs = dataclasses.replace(r.render_static, validation=True)
    cam = r.camera_tensor()
    render_frame(r.tscene, rs, cam)
    assert not errors
    bad = cam.clone()
    bad[3] = float("nan")     # the forward axis: every direction is NaN
    img = render_frame(r.tscene, rs, bad)
    assert not torch.isfinite(img).all()
    assert errors and all(e.startswith("validation: ") and "non-finite values in"
                          in e for e in errors), errors
    assert any(e.endswith("final ray directions") for e in errors)


def test_guard_costs_nothing_when_off(monkeypatch):
    """With validation off the guard is never called and the frame's host
    syncs are those of the loop; with it on, each wave adds two."""
    r = Renderer(scenes.two_box_scene(32, 32, 2, 2), "cpu")
    rs = r.render_static
    on = {}
    render_frame(r.tscene, dataclasses.replace(rs, validation=True),
                 r.camera_tensor(), stats=on)

    def refuse(*args, **kw):
        raise AssertionError("the guard ran with validation off")

    monkeypatch.setattr(validation, "guard", refuse)
    off = {}
    render_frame(r.tscene, rs, r.camera_tensor(), stats=off)
    assert on["host_syncs"] == off["host_syncs"] + 2


if __name__ == "__main__":
    # the raytpu comparisons' frames, in a process whose XLA_FLAGS the
    # parent set
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    np.savez(sys.argv[1], **_unfolded_frames(), **_chunked_frames(),
             **_filter_frames())
