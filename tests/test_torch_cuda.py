"""The CUDA kernels of the PyTorch port against their plain versions, on
the card. Marked ``cuda``: without a CUDA device every test skips. On a
machine with the card and no JAX (the conftest imports JAX unless
``RAYTPU_TEST_TPU=1`` is set):

    RAYTPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytpu_torch import _build, integrator, scenes
from raytpu_torch.config import MaterialType, ObjectConfig, RenderConfig
from raytpu_torch.integrator import plain_kernels, render_frame
from raytpu_torch.io.obj import Mesh, compute_smooth_normals
from raytpu_torch.device_scene import brute_scene, pack_tris
from raytpu_torch.ops import consensus, epilogue, intersect, mega, perlane, raygen, sky, trace, traverse
from raytpu_torch.render import Renderer
from raytpu_torch.scene import load_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def rig():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = Renderer(scenes.mixed_scene(64, 48, 2, 3), "cuda")
    r.set_transforms(0.1)
    rng = np.random.default_rng(9)
    p, k = 16, 1024
    u = rng.normal(size=(p * k, 3))
    o = u / np.linalg.norm(u, axis=1, keepdims=True) * 12.0
    d = rng.uniform(-3, 3, (p * k, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([o.T, d.T]), np.float32).reshape(6, p, k)).cuda()
    return r, rays


def test_sweeps_bitwise(rig):
    r, rays = rig
    ts = r.tscene
    win = torch.full(rays.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    st = traverse.make_trace_state(win)
    got = traverse.closest_sweep(ts, rays, 1e-3, st.clone())
    want = traverse.closest_sweep_ref(ts, rays, 1e-3, st.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[traverse.ST_VALID].view(torch.int32) != 0).float().mean() > 0.2

    tmax = win * 0.002
    occ = torch.zeros(rays.shape[1:], dtype=torch.int32, device="cuda")
    a = traverse.anyhit_sweep(ts, rays, 1e-3, tmax, occ.clone())
    b = traverse.anyhit_sweep_ref(ts, rays, 1e-3, tmax, occ.clone())
    assert torch.equal(a, b)


def test_raygen_and_sky(rig):
    r, rays = rig
    cam = r.camera_tensor()
    p = rays.shape[1]
    px = torch.randint(0, 800, (p, 1024), device="cuda").float()
    py = torch.randint(0, 600, (p, 1024), device="cuda").float()
    s_row = torch.arange(p, device="cuda").float() % 4
    a = raygen.raygen_packed(cam, s_row, px, py, 4, 800, 600)
    b = raygen.raygen_packed_ref(cam, s_row, px, py, 4, 800, 600)
    assert torch.equal(a[:3], b[:3])
    assert (a[3:].square().sum(0) - 1).abs().max() <= 1e-5
    assert (a[3:] - b[3:]).abs().max() <= 2.5 / 600
    assert (a[3:] - b[3:]).abs().max() <= 1e-5  # same f32 ops, one card
    assert raygen.jitter_error(a, cam, s_row, px, py, 4, 800, 600) <= raygen.JITTER_TOL

    h, w = r.tscene.sky_hw
    dirs = (rays[3], rays[4], -rays[5])
    for x, y in zip(sky.sample_cubemap_u32(r.tscene.skybox_u32, h, w, dirs),
                    sky.sample_cubemap_u32_ref(r.tscene.skybox_u32, h, w, dirs)):
        assert (x - y).abs().max() <= 1e-6


def test_sky_nearest_bitwise(rig):
    """K6's single-tap mode equals its plain version bit for bit, on the
    rig's directions and on the face edges and axes."""
    r, rays = rig
    h, w = r.tscene.sky_hw
    edge = torch.tensor([[1, 1, 0.3], [-1, 0.2, 1], [0.5, -1, -1], [0, 0, 1],
                         [0, -1, 0], [-1, 0, 0], [1, 1, 1]], device="cuda")
    for dirs in ((rays[3], rays[4], -rays[5]),
                 tuple(edge[:, c].contiguous() for c in range(3))):
        _build.reset_launch_counts()
        got = sky.sample_cubemap_u32_nearest(r.tscene.skybox_u32, h, w, dirs)
        assert _build.launch_counts()["sky_nearest"] == 1
        want = sky.sample_cubemap_u32_nearest_ref(r.tscene.skybox_u32, h, w, dirs)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_lbvh_on_card_equals_cpu():
    """The LBVH's steps 1-4 on the card give the tree of the same steps on
    CPU tensors, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raytpu_torch.accel import lbvh
    from raytpu_torch.io.genmesh import generate_highpoly

    mesh = generate_highpoly(depth=5, radius=3.0)
    tri = mesh.triangles.astype(np.int64)
    v0 = mesh.positions[tri[:, 0]]
    e1, e2 = mesh.positions[tri[:, 1]] - v0, mesh.positions[tri[:, 2]] - v0
    card = lbvh.build_lbvh(v0, e1, e2, leaf_size=12, device="cuda")
    host = lbvh.build_lbvh(v0, e1, e2, leaf_size=12, device="cpu")
    for a, b in zip(card, host):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_frame_goes_through_kernels(rig):
    """The default frame (auto -> mega on this scene), the chained-tier,
    the per-lane and the "xla" frames together launch every kernel, each
    tier its own sweeps, and render the same pixels ("xla" through the XLA
    body, whose shading rounds apart from the fused kernels')."""
    r, _ = rig
    assert r.tscene.auto_tier == "mega"
    counts, imgs = {}, {}
    for trav in ("auto", "pallas", "perlane", "xla"):
        ts = dataclasses.replace(r.tscene, traversal=trav)
        _build.reset_launch_counts()
        imgs[trav] = render_frame(ts, r.render_static, r.camera_tensor())
        counts[trav] = _build.launch_counts()
        assert counts[trav]["sky"] > 0 and counts[trav]["sky_nearest"] == 0
    _build.reset_launch_counts()     # the "nearest" filter: K6's single tap
    render_frame(r.tscene, dataclasses.replace(r.render_static,
                                               skybox_filter="nearest"),
                 r.camera_tensor())
    counts["nearest"] = _build.launch_counts()
    assert counts["nearest"]["sky_nearest"] > 0 and counts["nearest"]["sky"] == 0
    _build.reset_launch_counts()     # no BVH: the brute tracers' loop
    imgs["brute"] = render_frame(brute_scene(r.tscene), r.render_static,
                                 r.camera_tensor())
    counts["brute"] = _build.launch_counts()
    sweeps = {"auto": ("block_stats", "mega_closest_sweep", "mega_anyhit_sweep"),
              "pallas": ("closest_sweep", "anyhit_sweep"),
              "perlane": ("block_stats", "perlane_closest_sweep",
                          "perlane_anyhit_sweep"),
              "xla": ("mesh_closest", "mesh_anyhit"),
              "brute": ("brute_closest", "brute_anyhit")}
    every = {k for names in sweeps.values() for k in names}
    for trav, names in sweeps.items():
        assert all(counts[trav][k] > 0 for k in names), counts
        assert all(counts[trav][k] == 0 for k in every - set(names)), counts
    assert all(sum(c[k] for c in counts.values()) > 0
               for k in _build.KERNELS), counts
    assert torch.equal(imgs["auto"], imgs["pallas"])
    assert torch.equal(imgs["perlane"], imgs["pallas"])
    assert (imgs["xla"] - imgs["pallas"]).abs().max() <= 1e-5
    assert torch.equal(imgs["brute"], imgs["xla"])
    with plain_kernels():
        plain = render_frame(r.tscene, r.render_static, r.camera_tensor())
    assert torch.isfinite(imgs["auto"]).all()
    assert (imgs["auto"] - plain).abs().max() <= 1e-2  # raygen sinf ulps


def _wave_inputs(r, rays, p0, b):
    """Post-sweep state of a wave ``rays[:, p0:p0+b]`` (a strided view of
    the (6, P, K) buffer) and a fresh miss plane."""
    win = torch.full(rays.shape[1:], 1e4, device="cuda")
    win.view(-1)[::7] = 0.0
    st = traverse.make_trace_state(win[p0:p0 + b])
    st = traverse.closest_sweep(r.tscene, rays[:, p0:p0 + b], 1e-3, st)
    return st, torch.zeros((b, rays.shape[2]), dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("strided", [False, True])
def test_epilogue_kernels_match_plain(rig, strided):
    """K3 and K4 against their plain versions, on a whole buffer and on a
    wave of it whose planes lie apart (the kernels' plane strides)."""
    r, rays = rig
    light = r.tscene.light
    p0, b = (4, 8) if strided else (0, rays.shape[1])
    st, miss = _wave_inputs(r, rays, p0, b)
    outs = []
    for fn in (epilogue.shade_epilogue, epilogue.shade_epilogue_ref):
        buf = rays.clone()
        wave = buf[:, p0:p0 + b]
        assert wave.is_contiguous() != strided
        res = fn(wave, st, miss.clone(), light[:3], light[3])
        assert res[4].data_ptr() == wave.data_ptr()   # continuation in place
        outs.append((res, buf))
    (got, buf_k), (want, buf_p) = outs
    for a, w in zip(got, want):
        assert torch.equal(a, w) if a.dtype == torch.int32 else (
            _ulps(a, w) <= 2)
    assert torch.equal(buf_k, buf_p)   # lanes outside the wave untouched
    assert (got[3] != 0).any() and (got[5] > 0).any()

    srays, swin, ab, lit = got[:4]
    occ = traverse.anyhit_sweep(r.tscene, srays, 1e-3, swin, torch.zeros_like(lit))
    decay = torch.pow(0.9, torch.arange(b, device="cuda").float() % 2)
    tmps = []
    for fn in (epilogue.accumulate_epilogue, epilogue.accumulate_epilogue_ref):
        tmp = torch.ones((3, *rays.shape[1:]), device="cuda")
        fn(occ, ab, lit, tmp[:, p0:p0 + b], decay, light[:3], light[3])
        tmps.append(tmp)
    assert _ulps(*tmps) <= 2
    assert (tmps[0] != 1.0).any()


@pytest.mark.parametrize("strided", [False, True])
def test_block_stats_kernel_exact(rig, strided):
    """K7's stats rows against their plain version, in both entry orders,
    on a whole buffer and on a wave of it whose planes lie apart."""
    r, rays = rig
    p0, b = (8, 8) if strided else (0, rays.shape[1])
    wave = rays[:, p0:p0 + b]
    assert wave.is_contiguous() != strided
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::3] = 0.0
    win[:, :17] = 0.0
    want = mega.block_stats_ref(wave, win, 1e-3)
    for order in mega.ORDERS:
        got = mega.block_schedule(r.tscene, wave, win, 1e-3, order).stats
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        dead = mega.block_schedule(r.tscene, wave, torch.zeros_like(win), 1e-3,
                                   order).stats
        assert (dead[:, 16] == 0).all() and (dead[:, :3] == 3e38).all()


@pytest.mark.parametrize("strided", [False, True])
def test_perlane_sweeps_bitwise(rig, strided):
    """K1/K2 against their plain versions and against K10a/K10b, bit for
    bit, on a whole buffer and on a strided wave."""
    r, rays = rig
    ts = r.tscene
    p0, b = (8, 8) if strided else (0, rays.shape[1])
    wave = rays[:, p0:p0 + b]
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    st = traverse.make_trace_state(win)
    got = perlane.perlane_closest_sweep(ts, wave, 1e-3, st.clone())
    for want in (perlane.perlane_closest_sweep_ref(ts, wave, 1e-3, st.clone()),
                 traverse.closest_sweep(ts, wave, 1e-3, st.clone())):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[traverse.ST_VALID].view(torch.int32) != 0).float().mean() > 0.2

    tmax = win * 0.002
    occ = torch.zeros(wave.shape[1:], dtype=torch.int32, device="cuda")
    want = traverse.anyhit_sweep(ts, wave, 1e-3, tmax, occ.clone())
    assert (want != 0).any()
    for order in ("light", "origin"):
        got = perlane.perlane_anyhit_sweep(ts, wave, 1e-3, tmax, occ.clone(),
                                           order)
        plain = perlane.perlane_anyhit_sweep_ref(ts, wave, 1e-3, tmax,
                                                 occ.clone(), order)
        assert torch.equal(got, plain) and torch.equal(got, want)


def test_perlane_sweeps_any_packet_width(rig):
    """K1/K2's persistent warps take 32 lanes at a time, which span two
    culling blocks when a block (8 packets of K lanes) is not whole warps:
    each lane reads its own block's bit and octant, so they still equal
    their plain versions. Their launch bounds keep 4 CTAs on an SM."""
    r, rays = rig
    ts = r.tscene
    wave = rays[:, :, :20].contiguous()       # blocks of 160 lanes
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    st = traverse.make_trace_state(win)
    got = perlane.perlane_closest_sweep(ts, wave, 1e-3, st.clone())
    want = perlane.perlane_closest_sweep_ref(ts, wave, 1e-3, st.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[traverse.ST_VALID].view(torch.int32) != 0).any()
    tmax = win * 0.002
    occ = torch.zeros(wave.shape[1:], dtype=torch.int32, device="cuda")
    got = perlane.perlane_anyhit_sweep(ts, wave, 1e-3, tmax, occ.clone())
    assert torch.equal(got, perlane.perlane_anyhit_sweep_ref(ts, wave, 1e-3, tmax,
                                                             occ.clone()))
    assert (got != 0).any()
    for name, attrs in perlane.kernel_attributes().items():
        assert attrs["registers"] <= 64 and attrs["ctas_per_sm"] >= 4, (name, attrs)


@pytest.mark.parametrize("strided", [False, True])
def test_consensus_sweeps_bitwise(rig, strided):
    """K8/K9 against their plain versions and against K10a/K10b and K1/K2,
    bit for bit, on a whole buffer and on a strided wave."""
    r, rays = rig
    ts = r.tscene
    p0, b = (8, 8) if strided else (0, rays.shape[1])
    wave = rays[:, p0:p0 + b]
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    win[:, :64] = 0.0                  # two dead warps in every packet
    st = traverse.make_trace_state(win)
    got = consensus.mega_closest_sweep(ts, wave, 1e-3, st.clone())
    for want in (consensus.mega_closest_sweep_ref(ts, wave, 1e-3, st.clone()),
                 traverse.closest_sweep(ts, wave, 1e-3, st.clone()),
                 perlane.perlane_closest_sweep(ts, wave, 1e-3, st.clone())):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[traverse.ST_VALID].view(torch.int32) != 0).float().mean() > 0.2

    tmax = win * 0.002
    occ = torch.zeros(wave.shape[1:], dtype=torch.int32, device="cuda")
    occ[:, 100:140] = 1                  # OR-merge keeps these
    want = traverse.anyhit_sweep(ts, wave, 1e-3, tmax, occ.clone())
    assert (want != occ).any()
    for order in ("light", "origin"):
        got = consensus.mega_anyhit_sweep(ts, wave, 1e-3, tmax, occ.clone(),
                                          order)
        for other in (consensus.mega_anyhit_sweep_ref(ts, wave, 1e-3, tmax,
                                                      occ.clone(), order),
                      perlane.perlane_anyhit_sweep(ts, wave, 1e-3, tmax,
                                                   occ.clone(), order), want):
            assert torch.equal(got, other)


def test_consensus_sweeps_any_block_width(rig):
    """K8/K9 on blocks of 160 lanes (8 packets of 20): whole warps, but a CTA
    of 256 lanes spans two culling blocks, each warp with its own bit and
    octant; still equal to their plain versions. Their launch bounds keep
    4 CTAs on an SM with no local memory."""
    r, rays = rig
    ts = r.tscene
    wave = rays[:, :, :20].contiguous()
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    st = traverse.make_trace_state(win)
    got = consensus.mega_closest_sweep(ts, wave, 1e-3, st.clone())
    want = consensus.mega_closest_sweep_ref(ts, wave, 1e-3, st.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[traverse.ST_VALID].view(torch.int32) != 0).any()
    tmax = win * 0.002
    occ = torch.zeros(wave.shape[1:], dtype=torch.int32, device="cuda")
    got = consensus.mega_anyhit_sweep(ts, wave, 1e-3, tmax, occ.clone())
    assert torch.equal(got, consensus.mega_anyhit_sweep_ref(ts, wave, 1e-3, tmax,
                                                            occ.clone()))
    assert (got != 0).any()
    for name, attrs in consensus.kernel_attributes().items():
        assert attrs["local_bytes"] == 0, (name, attrs)
        assert attrs["registers"] <= 64 and attrs["ctas_per_sm"] >= 4, (name, attrs)


def _ulps(a, b):
    """Largest distance in f32 ulps (same-sign values)."""
    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return (ai - bi).abs().max().item()


@pytest.fixture(scope="module")
def soup():
    """A random triangle soup of 300 triangles on the card, and rays
    (6, 16, 1024) around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    pos = rng.uniform(-3, 3, (900, 3)).astype(np.float32)
    tris = np.arange(900, dtype=np.int32).reshape(300, 3)
    cfg = RenderConfig(objects=(ObjectConfig("soup", MaterialType.DIFFUSE,
                                             "static"),), width=32, height=32)
    mesh = Mesh(positions=pos, normals=compute_smooth_normals(pos, tris),
                triangles=tris, name="soup")
    r = Renderer(load_scene(cfg, meshes=[mesh],
                            skybox=np.full((6, 2, 2, 3), 0.5, np.float32)),
                 "cuda")
    p, k = 16, 1024
    u = rng.normal(size=(p * k, 3))
    o = u / np.linalg.norm(u, axis=1, keepdims=True) * 9.0
    d = rng.uniform(-2, 2, (p * k, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([o.T, d.T]), np.float32).reshape(6, p, k)).cuda()
    return r.tscene, rays


@pytest.mark.parametrize("strided", [False, True])
def test_mesh_walks_bitwise(soup, strided):
    """K11a and K11b against their plain versions, bit for bit, on a whole
    buffer and on a strided wave, with dead lanes and dead warps."""
    ts, rays = soup
    mesh = ts.entry_rows[0][2:]
    p0, b = (4, 8) if strided else (0, rays.shape[1])
    wave = rays[:, p0:p0 + b]
    assert wave.is_contiguous() != strided
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    win[:, :64] = 0.0                  # two dead warps in every packet
    got = traverse.mesh_closest(ts, mesh, wave, 1e-3, win)
    want = traverse.mesh_closest_ref(ts, mesh, wave, 1e-3, win)
    for a, w in zip((*got[:4], *got[4]), (*want[:4], *want[4])):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    assert (got[1] >= 0).float().mean() > 0.05
    tmax = win * 0.001
    occ = traverse.mesh_anyhit(ts, mesh, wave, 1e-3, tmax)
    assert torch.equal(occ, traverse.mesh_anyhit_ref(ts, mesh, wave, 1e-3, tmax))
    assert occ.any() and not occ.all()


@pytest.mark.parametrize("strided", [False, True])
def test_build_order_walks_bitwise(rig, strided):
    """K10a, K10b, K11a and K11b, over the packed records in build order,
    against their plain versions bit for bit on the three-entry scene, on a
    whole buffer and on a strided wave with dead lanes and dead warps: K10a
    and K10b over every entry (K10b OR-merging into flags already set on
    some lanes), K11a and K11b on each entry's object-space rays; the loop
    on K11a equal to K10a's sweep (t, normal, u, v, material, instance),
    the loop on K11b equal to K10b's flags."""
    r, rays = rig
    ts = r.tscene
    p0, b = (4, 8) if strided else (0, rays.shape[1])
    wave = rays[:, p0:p0 + b]
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    win[:, :64] = 0.0
    st = traverse.make_trace_state(win)
    got = traverse.closest_sweep(ts, wave, 1e-3, st.clone())
    want = traverse.closest_sweep_ref(ts, wave, 1e-3, st.clone())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[traverse.ST_VALID].view(torch.int32) != 0).float().mean() > 0.2
    assert len(ts.entry_rows) == 3
    for inst, _mat, nb, nc, tb in ts.entry_rows:
        obj = trace.object_space(ts, inst, tuple(wave[:3]), tuple(wave[3:]))
        k11 = traverse.mesh_closest(ts, (nb, nc, tb), obj, 1e-3, win)
        plain = traverse.mesh_closest_ref(ts, (nb, nc, tb), obj, 1e-3, win)
        for a, w in zip((*k11[:4], *k11[4]), (*plain[:4], *plain[4])):
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    o, d = tuple(wave[:3]), tuple(wave[3:])
    loop = trace.closest_hit_loop(ts, o, d, 1e-3, win)
    swept = trace.closest_hit_wave(ts, o, d, 1e-3, win)
    for a, w in zip((loop.t, *loop.n, loop.u, loop.v, loop.mat, loop.inst),
                    (swept.t, *swept.n, swept.u, swept.v, swept.mat, swept.inst)):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))

    tmax = win * 0.002
    occ0 = torch.zeros(win.shape, dtype=torch.int32, device="cuda")
    occ0.view(-1)[1::11] = 1               # already occluded: kept, not walked
    got = traverse.anyhit_sweep(ts, wave, 1e-3, tmax, occ0.clone())
    assert torch.equal(got, traverse.anyhit_sweep_ref(ts, wave, 1e-3, tmax,
                                                      occ0.clone()))
    fresh = traverse.anyhit_sweep(ts, wave, 1e-3, tmax, torch.zeros_like(occ0))
    assert (fresh != 0).any() and not (fresh != 0).all()
    for inst, _mat, nb, nc, tb in ts.entry_rows:
        obj = trace.object_space(ts, inst, tuple(wave[:3]), tuple(wave[3:]))
        assert torch.equal(traverse.mesh_anyhit(ts, (nb, nc, tb), obj, 1e-3, tmax),
                           traverse.mesh_anyhit_ref(ts, (nb, nc, tb), obj, 1e-3, tmax))
    assert torch.equal(trace.any_hit_loop(ts, o, d, 1e-3, tmax), fresh != 0)


def test_xla_frame_launches_mesh_walks(rig):
    """An "xla" frame renders through the XLA body, compacted, on K11a/K11b
    and launches no packed sweep and no fused shading; it is within 1e-5
    of the pallas tier's fused frame, whose shading kernels round apart
    from the body's ops."""
    r, _ = rig
    ts = dataclasses.replace(r.tscene, traversal="xla")
    _build.reset_launch_counts()
    stats = {}
    img = render_frame(ts, r.render_static, r.camera_tensor(), stats=stats)
    counts = _build.launch_counts()
    assert stats["tier"] == "xla"
    assert counts["mesh_closest"] > 0 and counts["mesh_anyhit"] > 0, counts
    assert all(n == 0 for k, n in counts.items()
               if k not in ("mesh_closest", "mesh_anyhit", "raygen", "sky")), counts
    pallas = render_frame(dataclasses.replace(ts, traversal="pallas"),
                          r.render_static, r.camera_tensor())
    assert (img - pallas).abs().max() <= 1e-5


def test_bench_run_benchmark_on_a_small_standin(rig):
    """The bench's ``run_benchmark`` on the config1 stand-in at 128x128, on
    the card: its default (consensus) tier, a finite frame time, and the
    ray count of the plain versions' frame."""
    from raytpu_torch import bench

    r = bench.build_preset_renderer(scenes.config1_standin(width=128, height=128))
    _build.reset_launch_counts()
    out = bench.run_benchmark(preset=r.scene, frames=3, renderer=r)
    counts = _build.launch_counts()
    assert out["backend"] == "cuda" and out["tier"] == "mega"
    assert counts["mega_closest_sweep"] > 0 and counts["mega_anyhit_sweep"] > 0, counts
    assert 0 < out["frame_ms"] < 1e4 and not out.get("suspect")
    with plain_kernels():
        plain = bench.count_rays_frame(r.tscene, r.render_static, r.camera_tensor())
    assert out["rays_per_frame"] == plain >= 128 * 128


def test_sharded_frame_on_repeated_slots_equals_single(rig):
    """Two slots on ``cuda:0`` (a mesh may repeat a card): each slot's
    thread launches the pallas tier's kernels, and the frame equals the
    single-device frame bit for bit."""
    from raytpu_torch.parallel import Mesh, render_sharded

    r, _ = rig
    ts = dataclasses.replace(r.tscene, traversal="pallas")
    want = render_frame(ts, r.render_static, r.camera_tensor())
    _build.reset_launch_counts()
    stats = {}
    got = render_sharded(ts, r.render_static, r.camera_tensor(),
                         Mesh(("cuda:0", "cuda:0")), stats=stats)
    counts = _build.launch_counts()
    assert stats["tier"] == "pallas" and len(stats["slots"]) == 2
    assert counts["closest_sweep"] > 0 and counts["anyhit_sweep"] > 0, counts
    assert got.device == torch.device("cuda", 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("strided", [False, True])
def test_brute_kernels_bitwise(soup, strided):
    """brute_closest_kernel and brute_anyhit_kernel against their plain
    versions, bit for bit, on every triangle of the soup's mesh (more than
    one shared-memory tile), with dead lanes, on a whole buffer and on a
    strided wave."""
    ts, rays = soup
    tris = brute_scene(ts).tri_packed
    assert tris.shape[0] > 256
    p0, b = (4, 8) if strided else (0, rays.shape[1])
    wave = rays[:, p0:p0 + b]
    win = torch.full(wave.shape[1:], 1e4, device="cuda")
    win.view(-1)[::5] = 0.0
    got = intersect.brute_closest(wave, win, tris, 1e-3)
    want = intersect.brute_closest_ref(wave, win, tris, 1e-3)
    for a, w in zip(got, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    assert (got[1] >= 0).float().mean() > 0.05
    tmax = win * 0.001
    occ = intersect.brute_anyhit(wave, tmax, tris, 1e-3)
    assert torch.equal(occ, intersect.brute_anyhit_ref(wave, tmax, tris, 1e-3))
    assert occ.any() and not occ.all()


# the any-hit kernel's edge shapes: (lanes, triangles, what the rays are)
ANYHIT_EDGES = {
    "tris_under_a_tile": (16384, 20, "soup"),
    "tris_a_tile_past_32k": (16384, 32 * 9 + 1, "soup"),
    "rays_under_a_warp": (20, 300, "soup"),
    "rays_far_above_resident": (1 << 21, 32 * 12 + 1, "soup"),
    "every_lane_dead": (16384, 300, "dead"),
    "only_the_last_triangle": (16384, 32 * 12 + 5, "last"),
    "strided_planes": (16384, 300, "strided"),
}


def _anyhit_case(n: int, n_tris: int, kind: str):
    """Seeded rays (6, n) and triangles (n_tris, 12) on the card for
    :data:`ANYHIT_EDGES`: a soup around the origin with every fifth lane
    dead; every lane dead; rays along +z that only the last triangle can
    occlude (the others lie beside them); or the soup's rays as the
    planes of a wider buffer."""
    rng = np.random.default_rng(n_tris + n % 1000)
    scale = 0.8 * max(1.0, (300 / n_tris) ** 0.5)
    v0 = rng.uniform(-3, 3, (n_tris, 3))
    e1 = rng.normal(scale=scale, size=(n_tris, 3))
    e2 = rng.normal(scale=scale, size=(n_tris, 3))
    if kind == "last":
        v0[:, 0] += 20.0
        v0[-1], e1[-1], e2[-1] = (-4, -4, 0), (12, 0, 0), (0, 12, 0)
        o = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.full((n, 1), -5.0)], 1)
        d = np.tile([0.0, 0.0, 1.0], (n, 1))
    else:
        u = rng.normal(size=(n, 3))
        o = u / np.linalg.norm(u, axis=1, keepdims=True) * 8.0
        d = rng.uniform(-2, 2, (n, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(6.0 if kind == "last" else 4.0, 14.0, n).astype(np.float32)
    if kind == "dead":
        tmax[:] = 0.0
    elif kind != "last":
        tmax[::5] = 0.0
    planes = np.concatenate([o.T, d.T]).astype(np.float32)
    if kind == "strided":
        wide = np.zeros((6, 3, n), np.float32)
        wide[:, 1] = planes
        rays = torch.from_numpy(wide).cuda()[:, 1]
    else:
        rays = torch.from_numpy(np.ascontiguousarray(planes)).cuda()
    tris = pack_tris(*(torch.from_numpy(x.astype(np.float32)).cuda()
                       for x in (v0, e1, e2)))
    return rays, torch.from_numpy(tmax).cuda(), tris


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("case", list(ANYHIT_EDGES))
def test_brute_anyhit_edges(card, case):
    """brute_anyhit_kernel flag for flag against brute_anyhit_ref on the
    shapes that stress its schedule: fewer triangles than a tile and a
    partial last tile, fewer rays than a warp and many more than the
    persistent grid's lanes (every lane refills), every lane dead, every
    lane occluded by the last triangle only (each warp's ring wraps to
    it), and planes of a wider buffer; the last two and the refills on
    rings long enough for the persistent grid, the others on the flat
    one."""
    n, n_tris, kind = ANYHIT_EDGES[case]
    rays, tmax, tris = _anyhit_case(n, n_tris, kind)
    if kind == "strided":
        assert rays.stride(0) == 3 * n
    _build.reset_launch_counts()
    occ = intersect.brute_anyhit(rays, tmax, tris, 1e-3)
    assert _build.launch_counts()["brute_anyhit"] == 1
    assert torch.equal(occ, intersect.brute_anyhit_ref(rays, tmax, tris, 1e-3))
    if kind == "dead":
        assert not occ.any()
    elif kind == "last":
        assert occ.all()
        assert not intersect.brute_anyhit_ref(rays, tmax, tris[:-1], 1e-3).any()
    else:
        assert occ.any() and not occ.all()
    if case == "rays_far_above_resident":
        grid = intersect.anyhit_grid(n, tris.shape[0], rays.device)
        assert n > 8 * grid * intersect.ANYHIT_THREADS


@pytest.fixture(scope="module")
def config4_slice():
    """The config4 stand-in (327,680-triangle armadillo, per-lane tier) at
    pose 0.1, and the primary rays and windows of chip_smoke's 256-packet
    slice around the frame's centre, with the shadow rays of their hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN

    r = Renderer(scenes.config4_standin(), "cuda")
    r.set_transforms(0.1)
    rays, act = chip_smoke.primary_wave(r)
    idx = torch.tensor(chip_smoke.sweep_slice(r.render_static, chip_smoke.SWEEP_PACKETS),
                       device="cuda")
    rays = rays[:, idx].contiguous()
    win = torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()
    st0 = traverse.make_trace_state(win)
    hits = perlane.perlane_closest_sweep(r.tscene, rays, RAY_TMIN, st0.clone())
    srays, tmax = chip_smoke.shadow_rays(r.tscene, rays, hits)
    return r, rays, st0, srays, tmax


def test_perlane_work_counts_equal_the_plain_walks(config4_slice):
    """K1's and K2's counting launches count exactly the node visits,
    triangle tests and record fetches of their plain walks on the config4
    slice."""
    from raytpu_torch.config import RAY_TMIN

    r, rays, st0, srays, tmax = config4_slice
    ts = r.tscene
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device="cuda")
    want = {"perlane_closest_sweep": {}, "perlane_anyhit_sweep": {}}
    perlane.perlane_closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone(),
                                      counts=want["perlane_closest_sweep"])
    occ = perlane.perlane_anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                           counts=want["perlane_anyhit_sweep"])
    assert occ.any() and not occ.all()
    _build.reset_work_counts()
    with _build.counting():
        perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone())
        perlane.perlane_anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())
    got = _build.work_counts()
    _build.reset_work_counts()
    for k in want:
        assert 0 < want[k]["fetches"] < want[k]["nodes"] and want[k]["tests"] > 0, want
        assert got[k] == {key: want[k][key] for key in _build.WORK_KEYS[k]}, (k, got)


def test_perlane_counting_launches_change_nothing(config4_slice, monkeypatch):
    """The counting and the non-counting launches of K1 and K2 give the same
    state and occlusion flags bit for bit; the viewer's frame
    (``Renderer.step``) passes no counters to any launch, a frame rendered
    with ``stats`` passes them to every K1 and K2 launch."""
    from raytpu_torch.config import RAY_TMIN

    r, rays, st0, srays, tmax = config4_slice
    ts = r.tscene
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device="cuda")
    plain = (perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone()),
             perlane.perlane_anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()))
    with _build.counting():
        counted = (perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone()),
                   perlane.perlane_anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()))
    _build.reset_work_counts()
    assert torch.equal(plain[0].view(torch.int32), counted[0].view(torch.int32))
    assert torch.equal(plain[1], counted[1])

    passed = []
    launch = _build.launch

    def spy(kernel, *args):
        if kernel in _build.WORK_KERNELS:
            passed.append(args[-1])
        return launch(kernel, *args)

    monkeypatch.setattr(_build, "launch", spy)
    r.step(0.2)
    assert passed and all(p is None for p in passed)
    passed.clear()
    r.render(stats={})
    assert passed and all(p is not None for p in passed)
    assert sum(_build.work_counts()["perlane_closest_sweep"].values()) > 0
    _build.reset_work_counts()


@pytest.fixture(scope="module", params=["config4", "tie", "one_leaf"])
def pair_rig(request):
    """A scene on the card, rays and their windows for K1/K2's pair walk:
    the config4 slice, the tie scene's primary wave (two instances of one
    box at the same place) and, around a mesh of one triangle (its tree's
    root is a leaf), rays aimed at it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from raytpu_torch.config import RAY_TMAX

    if request.param == "config4":
        r, rays, st0, _, _ = request.getfixturevalue("config4_slice")
        return r.tscene, rays, st0[traverse.ST_T]
    if request.param == "tie":
        r = Renderer(scenes.tie_scene(), "cuda")
        r.set_transforms(0.1)
        rays, act = chip_smoke.primary_wave(r)
        return r.tscene, rays, torch.where(act, RAY_TMAX, 0.0).float().contiguous()
    pos = np.array([[-3, -3, 0], [3, -3, 0], [0, 3, 0]], np.float32)
    tris = np.arange(3, dtype=np.int32).reshape(1, 3)
    cfg = RenderConfig(objects=(ObjectConfig("tri", MaterialType.DIFFUSE,
                                             "static"),), width=32, height=32)
    mesh = Mesh(positions=pos, normals=compute_smooth_normals(pos, tris),
                triangles=tris, name="tri")
    r = Renderer(load_scene(cfg, meshes=[mesh],
                            skybox=np.full((6, 2, 2, 3), 0.5, np.float32)), "cuda")
    assert r.tscene.bvh_tri_first.tolist() == [0] and r.tscene.pair_depth == 0
    rng = np.random.default_rng(5)
    p, k = 8, 1024
    u = rng.normal(size=(p * k, 3))
    o = u / np.linalg.norm(u, axis=1, keepdims=True) * 9.0
    d = rng.uniform(-3, 3, (p * k, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([o.T, d.T]), np.float32).reshape(6, p, k)).cuda()
    win = torch.full((p, k), RAY_TMAX, device="cuda")
    win.view(-1)[::5] = 0.0
    return r.tscene, rays, win


def test_pair_walks_equal_the_plain_walks(pair_rig):
    """K1's state and K2's flags equal their plain walks' bit for bit, and
    their counting launches count the plain walks' node visits, triangle
    tests and record fetches exactly, the counting and the plain launches
    giving the same bits. K2 runs on the same rays with windows of 0-30,
    so part of its lanes end their walks at a first hit."""
    from raytpu_torch.config import RAY_TMIN

    ts, rays, win = pair_rig
    st0 = traverse.make_trace_state(win)
    rng = np.random.default_rng(11)
    tmax = torch.where(win > 0, torch.from_numpy(rng.uniform(
        0, 30, win.shape).astype(np.float32)).cuda(), 0.0).contiguous()
    occ0 = torch.zeros(win.shape, dtype=torch.int32, device="cuda")
    want = {"perlane_closest_sweep": {}, "perlane_anyhit_sweep": {}}
    plain = (perlane.perlane_closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone(),
                                               counts=want["perlane_closest_sweep"]),
             perlane.perlane_anyhit_sweep_ref(ts, rays, RAY_TMIN, tmax, occ0.clone(),
                                              counts=want["perlane_anyhit_sweep"]))
    assert (plain[0][traverse.ST_VALID].view(torch.int32) != 0).any()
    assert plain[1].any() and not plain[1].all()
    got = (perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone()),
           perlane.perlane_anyhit_sweep(ts, rays, RAY_TMIN, tmax, occ0.clone()))
    _build.reset_work_counts()
    with _build.counting():
        counted = (perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone()),
                   perlane.perlane_anyhit_sweep(ts, rays, RAY_TMIN, tmax, occ0.clone()))
    work = _build.work_counts()
    _build.reset_work_counts()
    for states in (got, counted):
        assert torch.equal(states[0].view(torch.int32), plain[0].view(torch.int32))
        assert torch.equal(states[1], plain[1])
    for k, w in want.items():
        assert 0 < w["fetches"] <= w["nodes"] and w["tests"] > 0, (k, w)
        assert work[k] == {key: w[key] for key in _build.WORK_KEYS[k]}, (k, work)
        if ts.pair_depth == 0:
            assert w["fetches"] == w["nodes"]


@pytest.fixture(scope="module")
def config3_slice():
    """The config3 stand-in (the refractive Cornell room, consensus tier),
    the primary rays and windows of chip_smoke's 256-packet slice around
    the frame's centre, the refracted rays of their hits and the shadow
    rays from their hits, each with its window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.ops import shade
    from raytpu_torch.ops import vec3 as v3

    r = Renderer(scenes.config3_standin(), "cuda")
    r.set_transforms(0.1)
    rays, act = chip_smoke.primary_wave(r)
    idx = torch.tensor(chip_smoke.sweep_slice(r.render_static, chip_smoke.SWEEP_PACKETS),
                       device="cuda")
    rays = rays[:, idx].contiguous()
    win = torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()
    hits = consensus.mega_closest_sweep(r.tscene, rays, RAY_TMIN,
                                        traverse.make_trace_state(win))
    t, valid, _, _, nrm, _, _ = traverse.unpack_state(hits)
    d = tuple(rays[3:])
    pos = v3.add(tuple(rays[:3]), v3.scale(torch.where(valid, t, 0.0), d))
    ro, rd = shade.refract_bounce_soa(d, v3.normalize(nrm), pos)
    refracted = torch.stack((*ro, *rd)).contiguous()
    rwin = torch.where(valid, RAY_TMAX, 0.0).float().contiguous()
    srays, tmax = chip_smoke.shadow_rays(r.tscene, rays, hits)
    return r, ((rays, win), (refracted, rwin)), (srays, tmax)


def _consensus_sweeps(ts, waves, shadow, closest, anyhit):
    """``closest`` on both waves and ``anyhit`` on the shadow rays, from
    fresh states and flags: (the two states as int32, the flags)."""
    from raytpu_torch.config import RAY_TMIN

    states = tuple(closest(ts, rays, RAY_TMIN, traverse.make_trace_state(win))
                   .view(torch.int32) for rays, win in waves)
    srays, tmax = shadow
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device="cuda")
    return states, anyhit(ts, srays, RAY_TMIN, tmax, occ0)


def test_consensus_work_counts_equal_the_plain_walks(config3_slice):
    """K8's and K9's counting launches count exactly the four numbers of
    their plain walks (node visits and triangle tests of the walking lanes,
    and those of them the lanes' own walks need) on the config3 slice's
    primary wave, its refracted wave and its shadow rays."""
    r, waves, shadow = config3_slice
    want = {"mega_closest_sweep": {}, "mega_anyhit_sweep": {}}
    plain = _consensus_sweeps(
        r.tscene, waves, shadow,
        lambda *a: consensus.mega_closest_sweep_ref(*a, counts=want["mega_closest_sweep"]),
        lambda *a: consensus.mega_anyhit_sweep_ref(*a, counts=want["mega_anyhit_sweep"]))
    assert plain[1].any() and not plain[1].all()
    _build.reset_work_counts()
    with _build.counting():
        counted = _consensus_sweeps(r.tscene, waves, shadow, consensus.mega_closest_sweep,
                                    consensus.mega_anyhit_sweep)
    got = _build.work_counts()
    _build.reset_work_counts()
    assert all(torch.equal(a, b) for a, b in zip(plain[0], counted[0]))
    assert torch.equal(plain[1], counted[1])
    for k, w in want.items():
        assert set(w) >= set(_build.WORK_KEYS[k]) and all(v > 0 for v in w.values()), w
        assert got[k] == {key: w[key] for key in _build.WORK_KEYS[k]}, (k, got)
        assert w["own_nodes"] < w["nodes"] and w["own_tests"] <= w["tests"], w


def test_consensus_counting_launches_change_nothing(config3_slice, monkeypatch):
    """The counting and the non-counting launches of K8 and K9 give the same
    states and occlusion flags bit for bit; the viewer's frame
    (``Renderer.step``) passes no counters to any K8 or K9 launch, a frame
    rendered with ``stats`` passes them to every one."""
    r, waves, shadow = config3_slice
    sweeps = (consensus.mega_closest_sweep, consensus.mega_anyhit_sweep)
    plain = _consensus_sweeps(r.tscene, waves, shadow, *sweeps)
    with _build.counting():
        counted = _consensus_sweeps(r.tscene, waves, shadow, *sweeps)
    _build.reset_work_counts()
    assert all(torch.equal(a, b) for a, b in zip(plain[0], counted[0]))
    assert torch.equal(plain[1], counted[1])

    passed = []
    launch = _build.launch

    def spy(kernel, *args):
        if kernel in ("mega_closest_sweep", "mega_anyhit_sweep"):
            passed.append(args[-1])
        return launch(kernel, *args)

    monkeypatch.setattr(_build, "launch", spy)
    r.step(0.2)
    assert passed and all(p is None for p in passed)
    passed.clear()
    r.render(stats={})
    assert passed and all(p is not None for p in passed)
    assert sum(_build.work_counts()["mega_closest_sweep"].values()) > 0
    _build.reset_work_counts()


@pytest.fixture(scope="module")
def config2_small():
    """The benchmark's config2 (the static mirror teapot, 5,120 triangles,
    2 bounces, consensus tier) at 128x96 with a 64-texel sky on the card,
    through ``rtbench.run``'s viewer, and the closeup_mirror path's poses
    and time parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtbench import camerapath, manifest, run

    cell = manifest.Cell(manifest.load(), "config2.closeup")
    cfg = dict(cell.config, width=128, height=96,
               skybox=dict(cell.config["skybox"], size=64))
    meshes = [run.make_mesh(run.BENCH, o["mesh"]) for o in cfg["objects"]]
    sky = run.make_sky(cfg, 7, "cuda")
    poses, tps, _ = camerapath.make(cell.traffic, cfg, 7)
    return run.Viewer(run.port_renderer(cfg, meshes, sky, "cuda")), poses, tps


def test_consensus_later_counts_equal_the_plain_walks(config2_small):
    """A config2 frame rendered with ``stats`` on the card: K8's and K9's
    work counts, their later entries included, equal those of the same
    frame with the plain consensus walks in their place, and the frames
    are equal bit for bit."""
    viewer, poses, tps = config2_small
    viewer.pose(poses[41])
    r = viewer.renderer
    r.set_transforms(tps[41])
    stats = {}
    _build.reset_work_counts()
    img = r.render(stats=stats)
    got = _build.work_counts()
    _build.reset_work_counts()
    with integrator.kernels(mega_closest=consensus.mega_closest_sweep_ref,
                            mega_anyhit=consensus.mega_anyhit_sweep_ref):
        want_img = r.render(stats={})
    want = _build.work_counts()
    _build.reset_work_counts()
    assert stats["tier"] == "mega"
    assert torch.equal(img, want_img)
    assert got == want, (got, want)
    later = got["mega_closest_sweep" + _build.LATER]
    assert 0 < later["own_nodes"] < later["nodes"], later
    assert all(got["mega_closest_sweep"][k] > later[k] for k in later)


def test_replayed_later_sweeps_lie_inside_rt_later(config2_small):
    """Replayed config2 frames under the profiler: per frame one K8 launch
    (the first bounce's) outside every ``rt.later`` span and the rest,
    launched by graph replays, inside one; ``rt.later`` holds replays."""
    from rtbench import profiling, run, spans

    viewer, poses, tps = config2_small
    for k in range(3):      # the first frame eager, then the plan replays
        viewer.frame(poses[k], tps[k])
    trace = run.traced_loop(viewer, poses[3:6], tps[3:6], "cuda")

    def k8(ops):
        return [d for d in ops if d.kind == "kernel" and
                profiling.function_name(d.name) == "mega_closest_sweep_kernel"]

    inside = k8(spans.issued_inside(trace, "rt.later"))
    assert len(k8(trace.device)) - len(inside) == trace.frames
    assert len(inside) >= trace.frames
    names = {n for _, _, n, _ in trace._host}
    assert "rt.graph.replay" in names and "rt.bounce" not in names
    later = spans.spans(trace, "rt.later")
    replays = spans.spans(trace, "rt.graph.replay")
    assert spans.intersect(later, replays)


# ---------------------------------------------------------------------------
# the prepass in one launch: K7 with the schedule against the plain prepass
# ---------------------------------------------------------------------------

def _cone_wave(n_blocks: int, seed: int, k: int = 1024):
    """(6, 8 n_blocks, k) CUDA rays and their (8 n_blocks, k) window: per
    block a cone of rays aimed at the scene's centre from 8-14 units out,
    every third block pointing away, every fifth lane dead, block 5 (if
    any) dead and every fourth block's window short (9)."""
    rng = np.random.default_rng(seed)
    lanes = 8 * k
    o, d = [], []
    for b in range(n_blocks):
        u = rng.normal(size=3)
        ob = u / np.linalg.norm(u) * rng.uniform(8.0, 14.0) + rng.normal(
            scale=0.3, size=(lanes, 3))
        db = rng.uniform(-2.0, 2.0, 3) + rng.normal(scale=1.5, size=(lanes, 3)) - ob
        o.append(ob)
        d.append((-db if b % 3 == 2 else db) / np.linalg.norm(db, axis=1, keepdims=True))
    p = 8 * n_blocks
    rays = np.ascontiguousarray(np.concatenate([np.concatenate(o).T, np.concatenate(d).T]),
                                np.float32).reshape(6, p, k)
    win = np.full((p, k), 1e4, np.float32)
    win.reshape(-1)[::5] = 0.0
    win[40:48] = 0.0
    for b in range(0, n_blocks, 4):
        win[8 * b:8 * b + 8] = np.minimum(win[8 * b:8 * b + 8], 9.0)
    return torch.from_numpy(rays).cuda(), torch.from_numpy(win).cuda()


def _light_keys(ts):
    """The "light" order's keys of ``entry_perm``, on the scene's device."""
    lo, hi = mega.world_root_boxes(ts)
    lp = ts.light_pos
    sq = (torch.minimum(torch.maximum(lp, lo), hi) - lp).square()
    return sq[:, 0] + sq[:, 1] + sq[:, 2]


def _check_schedule(ts, rays, win, tmin=1e-3):
    """K7's schedule of ``rays`` against the plain prepass of the same rays
    moved to the CPU, in both orders: bits, octants and entry rows equal,
    the stats rows bit for bit, the "origin" depth within 1e-6 relative and
    the "light" keys exact; the culled sweeps' ``perlane.prepass`` takes
    the same schedule. Returns the "origin" schedule."""
    cpu = ts.to("cpu")
    r, w = rays.cpu(), win.cpu()
    _, _, depth = mega.chunk_block_hits(cpu, r, w, tmin)
    stats = mega.block_stats_ref(r, w, tmin)
    out = {}
    for order in mega.ORDERS:
        got = mega.block_schedule(ts, rays, win, tmin, order)
        want = perlane.prepass(cpu, r, w, tmin, order)
        for name, g, x in zip(("bits", "octs", "entries"), got, want):
            assert g.dtype == x.dtype == torch.int32
            assert torch.equal(g.cpu(), x), (order, name)
        assert torch.equal(got.stats.cpu().view(torch.int32), stats.view(torch.int32))
        if order == "origin":
            torch.testing.assert_close(got.keys.cpu(), depth, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got.keys.cpu(), _light_keys(cpu))
        for g, x in zip(perlane.prepass(ts, rays, win, tmin, order), want):
            assert torch.equal(g.cpu(), x)
        out[order] = got
    return out["origin"]


@pytest.mark.parametrize("case", ["whole", "strided", "pb40", "dead_block",
                                  "dead_wave"])
def test_block_schedule_equals_plain_prepass(rig, case):
    """Two blocks (whole, the second without a live lane, and one as a
    wave x[:, s:s+b] of a larger buffer), 40 blocks (not whole words of 32;
    block 5 dead), and a wave with no live lane."""
    r, rays = rig
    ts = r.tscene
    if case in ("whole", "strided", "dead_block"):
        p0, b = (8, 8) if case == "strided" else (0, rays.shape[1])
        wave = rays[:, p0:p0 + b]
        win = torch.full(wave.shape[1:], 1e4, device="cuda")
        win.view(-1)[::5] = 0.0
        if case == "dead_block":
            win[8:] = 0.0
    else:
        wave, win = _cone_wave(40, seed=3)
        if case == "dead_wave":
            win = torch.zeros_like(win)
    got = _check_schedule(ts, wave, win)
    pb = wave.shape[1] // mega.BLOCK_PACKETS
    blk = torch.arange(pb, device="cuda")
    hit = ((got.bits[:, blk >> 5] >> (blk & 31)) & 1).bool()
    if case == "dead_wave":
        assert not hit.any() and torch.equal(got.entries, ts.entries)
    else:
        assert hit.any()
    if case == "dead_block":
        assert not hit[:, 1].any()
    if case == "pb40":
        assert not hit[:, 5].any() and not hit.all()


def test_block_schedule_many_entries():
    """A chunked scene of 41 entries (more than a warp), on a wave of 40
    blocks inside a larger buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = Renderer(scenes.mixed_scene(32, 32, 1, 1, depth=3, chunk_tris=64), "cuda")
    r.set_transforms(0.1)
    assert r.tscene.entries.shape[0] > 32
    rays, win = _cone_wave(48, seed=8)
    got = _check_schedule(r.tscene, rays[:, 64:], win[64:])
    blk = torch.arange(40, device="cuda")
    hit = ((got.bits[:, blk >> 5] >> (blk & 31)) & 1).bool()
    assert hit.any() and not hit.all()


def test_block_schedule_of_no_block(rig):
    """A wave of no packet: no bit, no octant, the entries still ordered
    (all depths 0: build order; "light" as the plain order)."""
    r, rays = rig
    ts = r.tscene
    wave = rays[:, :0]
    win = torch.zeros(wave.shape[1:], device="cuda")
    e = ts.entries.shape[0]
    got = mega.block_schedule(ts, wave, win, 1e-3, "origin")
    assert got.bits.shape == (e, 0) and got.octs.shape == (0,)
    assert torch.equal(got.entries, ts.entries)
    light = mega.block_schedule(ts, wave, win, 1e-3, "light")
    assert torch.equal(light.entries,
                       ts.entries[mega.entry_perm(ts, None, "light")])


def test_block_schedule_on_config4_slice(config4_slice):
    """chip_smoke's 256-packet config4 slice (32 blocks: one whole word),
    its primary rays and the shadow rays of their hits."""
    r, rays, st0, srays, tmax = config4_slice
    _check_schedule(r.tscene, rays, st0[traverse.ST_T])
    _check_schedule(r.tscene, srays, tmax)


def test_prepass_is_one_launch_without_sync(rig):
    """One ``perlane.prepass`` call on the card launches K7 once (and the
    memset of its arrival counter) and nothing else, and makes no host
    sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r, rays = rig
    win = torch.full(rays.shape[1:], 1e4, device="cuda")
    for order in mega.ORDERS:
        perlane.prepass(r.tscene, rays, win, 1e-3, order)       # warm
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for order in mega.ORDERS:
                perlane.prepass(r.tscene, rays, win, 1e-3, order)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["block_stats"] == 2
    assert sum(counts.values()) == 2, counts
    # the device rows: the kernels and memsets, and the spans' annotations
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("rt.")]
    kernels = [n for n in device if "memset" not in n.lower()]
    assert len(kernels) == 2 and all("block_stats_kernel" in n for n in kernels), device
    assert len(device) == 4, device


# scenes of the CUDA graph tests: a config3-like consensus frame, the
# config4 stand-in (per-lane) with its orbiting armadillo, a deep loop
# (63 bounces: an any(lit) read a wave) on compacted waves and one at full
# width (no budget: an any(window) read a bounce)
GRAPH_SCENES = {
    "consensus": lambda: scenes.config3_standin(sky_size=64),
    "perlane": lambda: scenes.config4_standin(),
    "deep": lambda: scenes.mixed_scene(256, 192, 4, 63),
    "deep_full_width": lambda: scenes.mixed_scene(64, 48, 1, 63),
}


@pytest.mark.parametrize("name", list(GRAPH_SCENES))
def test_replayed_frames_equal_eager_frames(name, monkeypatch):
    """From the second frame of a shape on, ``Renderer.render`` replays the
    plan's CUDA graphs: at two camera poses and two time parameters the
    replayed frame equals the eager frame (``integrator.render_frame``) bit
    for bit, with no capture, no ``_build.launch`` call from Python, the
    eager frame's host reads and its launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from raytpu_torch import graphs, integrator
    from raytpu_torch.camera import Camera

    r = Renderer(GRAPH_SCENES[name](), "cuda")
    assert graphs.graphable(r.tscene, r.render_static)
    r.set_transforms(0.05)
    r.render()                    # eager, then the plan captures its units
    reads, launches, captures = [], [], []
    read, launch, capture = integrator._read, _build.launch, graphs.FramePlan._capture
    monkeypatch.setattr(integrator, "_read",
                        lambda x, stats: reads.append(1) or read(x, stats))
    monkeypatch.setattr(_build, "launch",
                        lambda *args: launches.append(args[0]) or launch(*args))
    monkeypatch.setattr(graphs.FramePlan, "_capture",
                        lambda plan, op: captures.append(op) or capture(plan, op))
    base = r.camera.state_dict()
    frames = []
    for turn, tp in ((0.0, 0.05), (30.0, 0.05), (0.0, 0.35), (30.0, 0.35)):
        cam = Camera.from_state_dict(base)
        cam.process_mouse_movement(turn, turn / 3)
        r.camera = cam
        r.set_transforms(tp)
        reads.clear(), launches.clear(), _build.reset_launch_counts()
        want = integrator.render_frame(r.tscene, r.render_static, r.camera_tensor())
        eager = (len(reads), _build.launch_counts())
        assert launches and eager[0] > 0
        reads.clear(), launches.clear(), _build.reset_launch_counts()
        got = r.render()
        assert not launches and not captures, (launches, captures)
        assert (len(reads), _build.launch_counts()) == eager
        assert torch.equal(got, want)
        frames.append(got)
    assert not torch.equal(frames[0], frames[1])       # a stale camera shows
    if name != "consensus":                             # config3 is static
        assert not torch.equal(frames[0], frames[2])   # stale transforms show


def test_the_profiler_records_replayed_kernels():
    """A replayed frame under ``torch.profiler`` shows its graphs' kernels
    as device events (K7, K8, K3, K4) and one ``rt.graph.replay`` span a
    replay, all inside ``rt.loop`` but the raygen's before it and the
    sky's after it, as an eager frame lays out its spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = Renderer(scenes.config3_standin(sky_size=64), "cuda")
    r.set_transforms(0.1)
    r.render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render()
        torch.cuda.synchronize()
    events = prof.events()
    device = " ".join(e.name for e in events if e.device_type == DeviceType.CUDA)
    for kernel in ("block_stats_kernel", "mega_closest_sweep_kernel",
                   "shade_epilogue_kernel", "accumulate_epilogue_kernel"):
        assert kernel in device, kernel
    names = [e.name for e in events]
    assert names.count("rt.graph.replay") >= 3
    assert "rt.graph.capture" not in names and "rt.bounce" not in names
    host = [e for e in events if e.device_type == DeviceType.CPU]
    (loop,) = [e.time_range for e in host if e.name == "rt.loop"]
    replays = sorted((e.time_range for e in host if e.name == "rt.graph.replay"),
                     key=lambda t: t.start)
    assert replays[0].end <= loop.start and replays[-1].start >= loop.end
    outside = [(t.start, t.end) for t in replays[1:-1]
               if not loop.start <= t.start <= t.end <= loop.end]
    assert not outside, ((loop.start, loop.end), outside)


@pytest.fixture(scope="module")
def moving():
    """A small scene on the card whose spinning and orbiting meshes change
    every frame, warmed so that its frames replay their graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = Renderer(scenes.mixed_scene(64, 48, 2, 3), "cuda")
    r.step(0.05)
    return r


def test_step_equals_the_rendered_frame(moving):
    """``step``'s array is ``render().cpu().numpy()`` of the same frame, bit
    for bit, as f32 (H, W, 3) C-contiguous."""
    got = moving.step(0.1)
    want = moving.render().cpu().numpy()
    assert got.dtype == np.float32 and got.shape == (48, 64, 3)
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


def test_step_reads_back_into_pinned_memory(moving):
    assert torch.from_numpy(moving.step(0.1)).is_pinned()


def test_kept_frames_stay_unchanged(moving):
    """Three kept frames of the moving scene stay distinct and unchanged
    while ten more frames render: every frame has a block of its own."""
    kept = [moving.step(t) for t in (0.1, 0.2, 0.3)]
    copies = [k.copy() for k in kept]
    later = [moving.step(0.4 + 0.1 * i) for i in range(10)]
    for k, c in zip(kept, copies):
        np.testing.assert_array_equal(k, c)
        assert not any(np.shares_memory(k, x) for x in later)
    for i in range(3):
        for j in range(i):
            assert not np.shares_memory(kept[i], kept[j])
            assert not np.array_equal(kept[i], kept[j])


def test_1080p_readback_is_one_pinned_copy():
    """Under the profiler a 1080p frame's readback is one ``aten::copy_``
    of the (1080, 1920, 3) image issuing one device-to-host memcpy into
    page-locked memory, as the benchmark's readback readers find it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from rtbench import profiling

    shape = [1080, 1920, 3]
    r = Renderer(scenes.mixed_scene(1920, 1080, 1, 0), "cuda")
    r.step(0.1), r.step(0.1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function(profiling.WINDOW):
            r.step(0.1)
        torch.cuda.synchronize()
    (copy,) = profiling.Trace(prof.profiler.kineto_results.events(), 1).copies_during(shape)
    assert copy.name == "Memcpy DtoH (Device -> Pinned)", copy.name
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    (readback,) = [e.time_range for e in events if e.name == "rt.readback"]
    inside = [e for e in events if e.name in profiling.COPY_OPS
              and readback.start <= e.time_range.start <= e.time_range.end <= readback.end]
    assert [(e.name, e.input_shapes[:2]) for e in inside] == [("aten::copy_", [shape, shape])]


# ---------------------------------------------------------------------------
# config5 (the glass cube and the mirror teapot, per-lane tier): K1/K2's
# later waves. Last in the file: run ahead of test_prepass_is_one_launch_
# without_sync, the traced config5 loop left that test's profiler with no
# device event (not understood; each passes alone and in this order).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def config5_small():
    """The benchmark's config5 at 128x64 (8 tiles at 1 spp, one block, so
    the per-lane tier) with a 64-texel sky on the card, through
    ``rtbench.run``'s viewer, and the closeup path's poses and time
    parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rtbench import camerapath, manifest, run

    cell = manifest.Cell(manifest.load(), "config5.closeup")
    cfg = dict(cell.config, width=128, height=64,
               skybox=dict(cell.config["skybox"], size=64))
    meshes = [run.make_mesh(run.BENCH, o["mesh"]) for o in cfg["objects"]]
    sky = run.make_sky(cfg, 7, "cuda")
    poses, tps, _ = camerapath.make(cell.traffic, cfg, 7)
    return run.Viewer(run.port_renderer(cfg, meshes, sky, "cuda")), poses, tps


def test_perlane_later_counts_equal_the_plain_walks(config5_small):
    """A config5 frame rendered with ``stats`` on the card: K1's and K2's
    work counts, their later entries included, equal those of the same
    frame with the plain per-lane walks in their place, and the frames are
    equal bit for bit."""
    viewer, poses, tps = config5_small
    viewer.pose(poses[41])
    r = viewer.renderer
    r.set_transforms(tps[41])
    stats = {}
    _build.reset_work_counts()
    img = r.render(stats=stats)
    got = _build.work_counts()
    _build.reset_work_counts()
    with integrator.kernels(perlane_closest=perlane.perlane_closest_sweep_ref,
                            perlane_anyhit=perlane.perlane_anyhit_sweep_ref):
        want_img = r.render(stats={})
    want = _build.work_counts()
    _build.reset_work_counts()
    assert stats["tier"] == "perlane"
    assert torch.equal(img, want_img)
    assert got == want, (got, want)
    later = got["perlane_closest_sweep" + _build.LATER]
    assert all(0 < later[k] < got["perlane_closest_sweep"][k] for k in later), got


def test_replayed_perlane_later_sweeps_lie_inside_rt_later(config5_small):
    """Replayed config5 frames under the profiler: per frame one K1 launch
    (the first bounce's) outside every ``rt.later`` span and the rest,
    launched by graph replays, inside one; no K2, K8 or K9 launch."""
    from rtbench import profiling, run, spans

    viewer, poses, tps = config5_small
    for k in range(3):      # the first frame eager, then the plan replays
        viewer.frame(poses[k], tps[k])
    trace = run.traced_loop(viewer, poses[3:6], tps[3:6], "cuda")

    def named(ops, name):
        return [d for d in ops if d.kind == "kernel" and
                profiling.function_name(d.name) == name]

    k1 = "perlane_closest_sweep_kernel"
    inside = named(spans.issued_inside(trace, "rt.later"), k1)
    assert len(named(trace.device, k1)) - len(inside) == trace.frames
    assert len(inside) >= trace.frames
    for other in ("perlane_anyhit_sweep_kernel", "mega_closest_sweep_kernel",
                  "mega_anyhit_sweep_kernel"):
        assert not named(trace.device, other), other
