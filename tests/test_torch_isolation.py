"""The PyTorch port stands apart from JAX and from raytpu, and its kernel
wrappers never fall back: a CPU tensor takes the plain version (no launch
counted), any other tensor must be a CUDA tensor or the wrapper raises."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytpu_torch import _build, scenes
from raytpu_torch.ops import consensus, epilogue, mega, perlane, raygen, sky, traverse
from raytpu_torch.render import Renderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# after the imports: neither jax nor any raytpu module is loaded
_NOTHING_OF_JAX_OR_RAYTPU = (
    "bad = sorted(m for m in sys.modules if m in ('jax', 'raytpu') or "
    "m.startswith(('jax.', 'raytpu.')))\n"
    "assert not bad, bad\n"
)


def _run_isolated(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code + _NOTHING_OF_JAX_OR_RAYTPU],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_never_imports_jax():
    """Every module (the sharding module and the native loaders' binding
    among them), an "xla" frame through the compacted body (the
    per-(instance, mesh) loop's plain walks) on the CPU, and the same frame
    sharded over two CPU slots."""
    _run_isolated(
        "import pkgutil, importlib, sys, raytpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "raytpu_torch.__path__, 'raytpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 25 and 'raytpu_torch.ops.consensus' in mods, mods\n"
        "assert {'raytpu_torch.parallel.dist', 'raytpu_torch.io.native'} <= set(mods)\n"
        "from raytpu_torch import scenes\n"
        "from raytpu_torch.parallel import make_mesh, render_sharded\n"
        "from raytpu_torch.render import Renderer\n"
        "r = Renderer(scenes.two_box_scene(64, 64, 2, 2, traversal='xla'), 'cpu')\n"
        "stats = {}\n"
        "img = r.render(stats=stats)\n"
        "assert img.std() > 0.01 and stats['tier'] == 'xla'\n"
        "assert (render_sharded(r.tscene, r.render_static, r.camera_tensor(),\n"
        "                       make_mesh(2, 'cpu')) == img).all()\n"
    )


def test_chip_smoke_imports_nothing_of_jax_or_raytpu():
    """chip_smoke's module and every phase's imports, without a card."""
    _run_isolated(
        "import sys, chip_smoke\n"
        "chip_smoke.import_port()\n"
    )


def test_renderer_defaults_to_the_card():
    device = inspect.signature(Renderer).parameters["device"]
    assert device.default == "cuda"


@pytest.fixture(scope="module")
def small():
    r = Renderer(scenes.two_box_scene(32, 32, 1, 1), "cpu")
    r.set_transforms(0.2)
    rng = np.random.default_rng(5)
    p, k = 2, 64
    d = rng.normal(size=(3, p, k)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    o = np.zeros((3, p, k), np.float32)
    o[2] = 12.0
    rays = torch.from_numpy(np.concatenate([o, d]))
    return r, rays


def test_cpu_wrappers_take_plain_path(small):
    r, rays = small
    ts = r.tscene
    _build.reset_launch_counts()
    win = torch.full(rays.shape[1:], 1e4)
    st = traverse.make_trace_state(win)
    got = traverse.closest_sweep(ts, rays, 1e-3, st.clone())
    want = traverse.closest_sweep_ref(ts, rays, 1e-3, st.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[traverse.ST_VALID].view(torch.int32) != 0).any())

    occ0 = torch.zeros(rays.shape[1:], dtype=torch.int32)
    assert torch.equal(traverse.anyhit_sweep(ts, rays, 1e-3, win, occ0.clone()),
                       traverse.anyhit_sweep_ref(ts, rays, 1e-3, win, occ0.clone()))

    cam = r.camera_tensor()
    px = torch.arange(128, dtype=torch.float32).reshape(2, 64)
    s_row = torch.tensor([0.0, 1.0])
    assert torch.equal(raygen.raygen_packed(cam, s_row, px, px, 2, 32, 32),
                       raygen.raygen_packed_ref(cam, s_row, px, px, 2, 32, 32))

    dirs = (rays[3], rays[4], rays[5])
    h, w = ts.sky_hw
    for a, b in zip(sky.sample_cubemap_u32(ts.skybox_u32, h, w, dirs),
                    sky.sample_cubemap_u32_ref(ts.skybox_u32, h, w, dirs)):
        assert torch.equal(a, b)

    st0 = traverse.closest_sweep_ref(ts, rays, 1e-3, st.clone())
    light = ts.light
    outs = [fn(rays.clone(), st0, torch.zeros(win.shape, dtype=torch.int32),
               light[:3], light[3])
            for fn in (epilogue.shade_epilogue, epilogue.shade_epilogue_ref)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    srays, swin, ab, lit, _, _, _ = outs[0]
    tmps = [torch.ones((3, *win.shape)) for _ in range(2)]
    decay = torch.tensor([1.0, 0.9])
    epilogue.accumulate_epilogue(occ0, ab, lit, tmps[0], decay, light[:3], light[3])
    epilogue.accumulate_epilogue_ref(occ0, ab, lit, tmps[1], decay, light[:3], light[3])
    assert torch.equal(*tmps)

    # the per-lane tier's wrappers, on whole blocks of 8 packets
    prays = rays.repeat(1, 4, 1)
    pwin = torch.full(prays.shape[1:], 1e4)
    for order in mega.ORDERS:
        for a, b in zip(perlane.prepass(ts, prays, pwin, 1e-3, order),
                        perlane.plain_prepass(ts, prays, pwin, 1e-3, order)):
            assert torch.equal(a, b)
    pst = traverse.make_trace_state(pwin)
    got = perlane.perlane_closest_sweep(ts, prays, 1e-3, pst.clone())
    want = perlane.perlane_closest_sweep_ref(ts, prays, 1e-3, pst.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pocc = torch.zeros(prays.shape[1:], dtype=torch.int32)
    assert torch.equal(
        perlane.perlane_anyhit_sweep(ts, prays, 1e-3, pwin, pocc.clone()),
        perlane.perlane_anyhit_sweep_ref(ts, prays, 1e-3, pwin, pocc.clone()))
    # and the consensus tier's
    got = consensus.mega_closest_sweep(ts, prays, 1e-3, pst.clone())
    want = consensus.mega_closest_sweep_ref(ts, prays, 1e-3, pst.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(
        consensus.mega_anyhit_sweep(ts, prays, 1e-3, pwin, pocc.clone()),
        consensus.mega_anyhit_sweep_ref(ts, prays, 1e-3, pwin, pocc.clone()))
    # and the one-mesh walks of the per-(instance, mesh) loop
    mesh = ts.entry_rows[0][2:]
    t, slot, u, v, n = traverse.mesh_closest(ts, mesh, rays, 1e-3, win)
    want = traverse.mesh_closest_ref(ts, mesh, rays, 1e-3, win)
    for a, b in zip((t, slot, u, v, *n), (*want[:4], *want[4])):
        assert torch.equal(a, b)
    assert bool((slot >= 0).any())
    assert torch.equal(traverse.mesh_anyhit(ts, mesh, rays, 1e-3, win),
                       traverse.mesh_anyhit_ref(ts, mesh, rays, 1e-3, win))

    img = r.render_np()
    assert np.isfinite(img).all()
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_non_cpu_tensor_needs_cuda(small):
    """A tensor that is not on the CPU goes to the kernel: the device check
    refuses anything but CUDA (a meta tensor stands in, no GPU needed)."""
    r, rays = small
    _build.reset_launch_counts()
    meta_rays = rays.to("meta")
    state = traverse.make_trace_state(torch.full(rays.shape[1:], 1e4)).to("meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        traverse.closest_sweep(r.tscene, meta_rays, 1e-3, state)
    tm = torch.zeros(rays.shape[1:], device="meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        traverse.anyhit_sweep(r.tscene, meta_rays, 1e-3, tm,
                              tm.to(torch.int32))
    px = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        raygen.raygen_packed(r.camera_tensor().to("meta"), px[:, 0], px, px,
                             1, 32, 32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        sky.sample_cubemap_u32(r.tscene.skybox_u32, *r.tscene.sky_hw,
                               (px, px, px))
    miss = torch.zeros(rays.shape[1:], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        epilogue.shade_epilogue(meta_rays, state, miss, (5.0, 5.0, 5.0), 1.0)
    ab = torch.zeros((2, *rays.shape[1:]), device="meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        epilogue.accumulate_epilogue(miss, ab, miss, state[:3], px[:, 0],
                                     (5.0, 5.0, 5.0), 1.0)
    prays = meta_rays.repeat(1, 4, 1)
    pwin = torch.zeros(prays.shape[1:], device="meta")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        perlane.prepass(r.tscene, prays, pwin, 1e-3, "origin")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        perlane.perlane_closest_sweep(r.tscene, prays, 1e-3,
                                      state.repeat(1, 4, 1))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        perlane.perlane_anyhit_sweep(r.tscene, prays, 1e-3, pwin,
                                     pwin.to(torch.int32))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        consensus.mega_closest_sweep(r.tscene, prays, 1e-3,
                                     state.repeat(1, 4, 1))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        consensus.mega_anyhit_sweep(r.tscene, prays, 1e-3, pwin,
                                    pwin.to(torch.int32))
    mesh = r.tscene.entry_rows[0][2:]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        traverse.mesh_closest(r.tscene, mesh, meta_rays, 1e-3, tm)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        traverse.mesh_anyhit(r.tscene, mesh, meta_rays, 1e-3, tm)
    with pytest.raises(ValueError, match="whole warps"):   # 2 x 60 lanes
        traverse.mesh_closest(r.tscene, mesh, meta_rays[:, :, :60], 1e-3,
                              tm[:, :60])
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_launch_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal path is CPU-only")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.launch("sky")
    assert _build.launch_counts()["sky"] == 0


def test_unported_config_values_raise():
    """Every value the port renders is accepted (brute force, chunks and
    the builders among them); values it does not know still raise, and
    the JAX package's scheduling knobs and ignored fields are no fields."""
    from raytpu_torch.integrator import RenderStatic

    base = scenes.two_box_scene().config
    assert base.wavefront == "compact"
    RenderStatic.from_config(base)  # the asset-free default is accepted
    RenderStatic.from_config(base.replace(wavefront="full"))
    for knob in (dict(wavefront="sorted"), dict(skybox_filter="cubic"),
                 dict(ray_chunk=-1), dict(devices=0),
                 dict(traversal="bvh"), dict(chunk_tris=-1),
                 dict(bvh_builder="kd")):
        with pytest.raises(ValueError):
            RenderStatic.from_config(base.replace(**knob))
    for knob in (dict(divergence="split"), dict(bounce_unroll=True),
                 dict(sky_rebin="on"), dict(sky_sampler="gather"),
                 dict(dtype="bfloat16")):
        with pytest.raises(TypeError):
            base.replace(**knob)
    # the values ported in the options slice and the knobs slice
    for knob in (dict(skybox_filter="nearest"), dict(skybox_filter="bilinear2x"),
                 dict(ray_chunk=4096), dict(validation=True), dict(devices=2),
                 dict(bvh_builder="sah"), dict(bvh_builder="median"),
                 dict(bvh_builder="lbvh"), dict(bvh_builder="native"),
                 dict(bvh_builder="brute"), dict(traversal="brute"),
                 dict(chunk_tris=256)):
        rs = RenderStatic.from_config(base.replace(**knob))
        for name, value in knob.items():
            assert name in ("bvh_builder", "devices", "traversal",
                            "chunk_tris") or getattr(rs, name) == value
    for trav in ("auto", "pallas", "xla", "perlane", "mega", "hybrid", "brute"):
        RenderStatic.from_config(base.replace(traversal=trav))
    assert not RenderStatic(32, 32, 2, 1, fold_spp=False).fold_spp
    RenderStatic(32, 32, 2, 1, wavefront="full")
    for bad in (dict(ladder="on"), dict(shadow_order="far"),
                dict(skybox_filter="trilinear")):
        with pytest.raises(ValueError):
            RenderStatic(32, 32, 2, 1, **bad)
    for gone in (dict(fused="off"), dict(divergence="sort"),
                 dict(bounce_unroll=True)):
        with pytest.raises(TypeError):
            RenderStatic(32, 32, 2, 1, **gone)


def test_plain_kernels_swaps_and_restores(small):
    """``plain_kernels`` routes the frame through the plain versions for the
    block only, also when the block raises."""
    from raytpu_torch import integrator

    r, _ = small
    before = dict(integrator._KERNELS)
    with integrator.plain_kernels():
        assert integrator._KERNELS == integrator._PLAIN
        plain = r.render_np()
    with pytest.raises(KeyError):
        with integrator.plain_kernels():
            raise KeyError("inside")
    assert integrator._KERNELS == before
    np.testing.assert_array_equal(plain, r.render_np())  # CPU: same path
