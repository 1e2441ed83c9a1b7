"""The port's BVH builders against raytpu's, on the CPU: the host SAH and
median builders (``raytpu_torch/accel/bvh.py``) and the LBVH
(``raytpu_torch/accel/lbvh.py``, its steps 1-4 on CPU tensors here) give
raytpu's trees bit for bit; the digests ``chip_smoke`` pins are those of
raytpu's trees; and each builder's frame equals raytpu's frame with the same
builder from the same primary rays within 1e-5 (rendered in a child process
without FMA, as ``test_torch_options.py`` explains).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytpu import integrator as ji
from raytpu.accel import bvh as jbvh
from raytpu.accel import lbvh as jlbvh
from raytpu_torch import scenes
from raytpu_torch.accel import bvh, lbvh
from raytpu_torch.integrator import detile, render_packets, tiled_pixels
from raytpu_torch.io.genmesh import generate_highpoly
from raytpu_torch.render import Renderer
from tests.test_torch_options import NO_FMA, _jax_rays, _jax_wave, _setup
from tests.torch_twin import one_thread

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("aabb_min", "aabb_max", "tri_first", "tri_count", "miss", "tri_order")
BUILDERS = ("sah", "median", "lbvh")


def _corners(mesh):
    tri = mesh.triangles.astype(np.int64)
    p = mesh.positions
    v0 = p[tri[:, 0]]
    return v0, p[tri[:, 1]] - v0, p[tri[:, 2]] - v0


def _soup(n: int, seed: int, copies: int = 1):
    """Seeded random triangles; with ``copies`` > 1 each one repeats that
    many times, moved by far less than a Morton cell, so that many
    centroids share a code."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    if copies > 1:
        v0 = np.repeat(v0, copies, axis=0) + rng.uniform(
            0, 1e-5, (n * copies, 3)).astype(np.float32)
        e1, e2 = np.repeat(e1, copies, axis=0), np.repeat(e2, copies, axis=0)
    return v0, e1, e2


MESHES = {
    "box": lambda: _corners(scenes.box_mesh((0.0, 0.0, 0.0), 1.0)),
    "teapot_standin": lambda: _corners(generate_highpoly(depth=4, radius=3.0)),
    "soup": lambda: _soup(700, seed=3),
    "duplicates": lambda: _soup(60, seed=4, copies=12),
}


def _assert_same(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("mesh", ["box", "teapot_standin", "soup"])
@pytest.mark.parametrize("method", ["sah", "median"])
def test_host_builder_matches_raytpu(mesh, method):
    v0, e1, e2 = MESHES[mesh]()
    got = bvh.build_bvh(v0, e1, e2, leaf_size=12, method=method)
    _assert_same(got, jbvh.build_bvh(v0, e1, e2, leaf_size=12, method=method))
    bvh.validate_bvh(got, v0, e1, e2)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_lbvh_matches_raytpu(mesh):
    v0, e1, e2 = MESHES[mesh]()
    got = lbvh.build_lbvh(v0, e1, e2, leaf_size=12, device="cpu")
    _assert_same(got, jlbvh.build_lbvh(v0, e1, e2, leaf_size=12))
    bvh.validate_bvh(got, v0, e1, e2)
    if mesh == "duplicates":
        cent = torch.from_numpy(np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
                                + np.maximum(np.maximum(v0, v0 + e1), v0 + e2)) * 0.5
        codes = lbvh.morton_codes(cent)
        assert codes.unique().numel() < codes.numel() // 4  # many shared codes


def test_clz_matches_lax():
    x = np.concatenate([2 ** np.arange(31), 2 ** np.arange(1, 31) - 1,
                        2 ** np.arange(1, 31) + 1, [2 ** 31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(lbvh._clz(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.lax.clz(jnp.asarray(x))))


@pytest.mark.parametrize("name,method", [("LBVH_DIGEST", "lbvh"),
                                         ("SAH_DIGEST", "sah"),
                                         ("MEDIAN_DIGEST", "median")])
def test_pinned_digests_are_raytpu_trees(name, method):
    """chip_smoke's pinned digests are those of raytpu's trees of the
    teapot stand-in (the config2 stand-in's mesh), leaf size 12, and
    ``chip_smoke.first_tree`` takes the port's tree out of a config2
    stand-in scene built with that builder."""
    v0, e1, e2 = MESHES["teapot_standin"]()
    want = (jlbvh.build_lbvh(v0, e1, e2, leaf_size=12) if method == "lbvh"
            else jbvh.build_bvh(v0, e1, e2, leaf_size=12, method=method))
    assert chip_smoke.tree_digest([getattr(want, f) for f in FIELDS]) \
        == getattr(chip_smoke, name)
    with one_thread():
        ts = Renderer(scenes.config2_standin(16, width=32, height=32,
                                             bvh_builder=method), "cpu").tscene
    assert chip_smoke.tree_digest(chip_smoke.first_tree(ts)) == getattr(chip_smoke, name)


def _builder_frames():
    """mixed_scene(64, 48, spp 2, bounces 3) per builder: raytpu's frame
    (its builder's tree) and the port's (its own builder's tree) from the
    same rays."""
    out = {}
    for method in BUILDERS:
        scene = scenes.mixed_scene(64, 48, 2, 3, bvh_builder=method)
        jr, rs_j, cam, (px, py, act), _, rs = _setup(scene)
        spp, (p, k) = 2, px.shape
        s_idx = jnp.tile(jnp.arange(spp, dtype=jnp.float32), (p,))[:, None] \
            * jnp.ones((1, k), jnp.float32)
        o, d, arr = _jax_rays(cam, jnp.repeat(px, spp, axis=0),
                              jnp.repeat(py, spp, axis=0), s_idx, spp, 64, 48)
        c = _jax_wave(jr.device_scene, jr.static, rs_j, o, d, s_idx,
                      jnp.repeat(act, spp, axis=0))
        out[f"{method}_want"] = np.asarray(ji.detile(
            tuple(x.reshape(p, spp, k).mean(axis=1) for x in c), rs_j))
        r = Renderer(scene, "cpu")
        r.set_transforms(0.1)
        (tpx, tpy), t_in = tiled_pixels(rs, "cpu")
        out[f"{method}_got"] = detile(render_packets(
            r.tscene, rs, torch.from_numpy(np.array(cam)), tpx, tpy, t_in,
            rays6=torch.from_numpy(arr)), rs).numpy()
    return out


@pytest.fixture(scope="module")
def child_frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("builders") / "frames.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("method", BUILDERS)
def test_builder_frame_matches_raytpu(child_frames, method):
    got, want = child_frames[f"{method}_got"], child_frames[f"{method}_want"]
    assert got.shape == want.shape == (48, 64, 3) and want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


if __name__ == "__main__":
    # the frames, in a process whose XLA_FLAGS the parent set
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    np.savez(sys.argv[1], **_builder_frames())
