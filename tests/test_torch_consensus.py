"""The consensus tier of the PyTorch port (``raytpu_torch/ops/consensus.py``,
the plain versions of K8 and K9, and the wide links of ``ops/mega.py``)
against raytpu and against the port's other tiers, on the CPU:

* ``treelet_partition`` and ``widen_octant_links`` against raytpu's on
  seeded random trees, with and without kept nodes, and the wide links of a
  ``from_raytpu`` scene against the (chunk, octant) rows of raytpu's packed
  ``mega_oct`` table: exact;
* plain K8 against plain K1 and plain K10a (all 9 state planes) and plain
  K9 against plain K2 and K10b (occlusion), bit for bit, on the two-box,
  three-material and both stand-in scenes;
* the consensus tier's frames of the config2 and config3 stand-ins against
  the chained tier's (bit for bit) and against raytpu's frame of the same
  scene from the same primary rays (1e-5 per pixel, SSIM > 0.98).

The plain K8 against the JAX chain is a case of ``test_torch_traverse.py``;
the tier table, the tie scene and the wrappers' refusals are in
``test_torch_perlane.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytpu.ops import mega as jmega
from raytpu.ops import perlane as jperlane
from raytpu.render import Renderer as JaxRenderer
from raytpu.utils.ssim import ssim
from raytpu_torch import scenes
from raytpu_torch.device_scene import from_raytpu
from raytpu_torch.integrator import render_frame
from raytpu_torch.ops import consensus, mega, perlane, traverse
from raytpu_torch.render import Renderer
from tests.test_torch_frame import _same_rays_frames
from tests.torch_twin import cone_rays, one_thread, raytpu_twin

TMIN = 1e-3
T_ANIM = 0.1
NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent
STANDINS = {"config2": scenes.config2_standin,
            "config3": scenes.config3_standin}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _random_tree(rng, n_leaves: int):
    """A seeded flat DFS tree with ``n_leaves`` leaves of 1-7 triangles,
    each inner node splitting its leaves between a quarter and three
    quarters, and random boxes: (aabb_min, aabb_max, first, count, miss)."""
    first, count, miss = [], [], []
    slot = 0

    def build(nl):
        nonlocal slot
        idx = len(first)
        first.append(-1)
        count.append(0)
        miss.append(-1)
        if nl == 1:
            first[idx] = slot
            count[idx] = int(rng.integers(1, 8))
            slot += count[idx]
        else:
            k = int(rng.integers(max(1, nl // 4), 3 * nl // 4 + 1))
            build(min(k, nl - 1))
            build(nl - min(k, nl - 1))
        miss[idx] = len(first)

    build(n_leaves)
    n = len(first)
    lo = rng.normal(size=(n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    return (lo, hi, np.asarray(first, np.int32), np.asarray(count, np.int32),
            np.asarray(miss, np.int32))


@pytest.mark.parametrize("n_leaves", [1, 2, 5, 60, 700])
def test_wide_links_match_raytpu_on_random_trees(n_leaves):
    rng = np.random.default_rng(n_leaves)
    lo, hi, first, count, miss = _random_tree(rng, n_leaves)
    tid, nt = mega.treelet_partition(first, miss)
    want_tid, want_nt = jperlane.treelet_partition(first, count, miss)
    assert nt == want_nt
    np.testing.assert_array_equal(tid, want_tid)
    succ, skip = mega.octant_links(lo, hi, first, miss)
    for keep in (None, rng.random(first.shape[0]) < 0.2):
        got = mega.widen_octant_links(succ, skip, first, miss, keep_extra=keep)
        want = jmega.widen_octant_links(succ, skip, first, miss,
                                        keep_extra=keep)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == (8, first.shape[0])
            np.testing.assert_array_equal(g, w)
    if n_leaves > 100:   # deep enough that the walk skips levels
        assert (got[0] != succ).any()


@pytest.mark.parametrize("name", ["two_box", "mixed", "mixed_chunked",
                                  "config2"])
def test_wide_links_match_raytpu_mega_oct(name):
    """The port's wide links of raytpu's own trees equal the (chunk,
    octant) rows of raytpu's packed table (succ, then skip at pad_nodes)."""
    scene = {
        "two_box": lambda: scenes.two_box_scene(32, 32, 1, 1),
        "mixed": lambda: scenes.mixed_scene(32, 32, 1, 1, depth=3),
        "mixed_chunked": lambda: scenes.mixed_scene(32, 32, 1, 1, depth=2,
                                                    chunk_tris=128),
        "config2": lambda: scenes.config2_standin(16, width=32, height=32),
    }[name]()
    jr = JaxRenderer(raytpu_twin(scene))
    dev, static = jr.device_scene, jr.static
    assert static.mega_layout is not None
    ts = from_raytpu(dev, static, "cpu")
    n_chunks = len(static.mesh_node_ranges)
    pad_nodes = static.mega_layout[0]
    table = np.asarray(dev.mega_oct).reshape(n_chunks, 8, -1)
    dropped = 0
    for c, (b, n) in enumerate(static.mesh_node_ranges):
        np.testing.assert_array_equal(ts.wide_succ[:, b:b + n].numpy(),
                                      table[c, :, :n])
        np.testing.assert_array_equal(ts.wide_skip[:, b:b + n].numpy(),
                                      table[c, :, pad_nodes:pad_nodes + n])
        dropped += int((ts.wide_succ[:, b:b + n] == n).sum())
    if name in ("mixed", "config2"):
        assert dropped > 0        # interior levels left the threading


def _scene(name):
    """A CPU scene of each kind at a test size, posed."""
    make = {
        "two_box": lambda: scenes.two_box_scene(32, 32, 2, 2),
        "mixed": lambda: scenes.mixed_scene(32, 32, 2, 2, depth=3),
        "config2": lambda: scenes.config2_standin(16, width=32, height=32),
        "config3": lambda: scenes.config3_standin(16, width=32, height=32),
    }[name]
    r = Renderer(make(), "cpu")
    r.set_transforms(T_ANIM)
    return r.tscene


@pytest.mark.parametrize("name", ["two_box", "mixed", "config2", "config3"])
def test_consensus_plain_matches_perlane_and_chained(name):
    ts = _scene(name)
    assert ts.auto_tier == "mega"
    rays, win = (torch.from_numpy(x) for x in cone_rays(4, seed=31))
    st0 = traverse.make_trace_state(win)
    work = {}
    got = consensus.mega_closest_sweep_ref(ts, rays, TMIN, st0.clone(),
                                           counts=work.setdefault("K8", {}))
    for name_, want in (
            ("K1", perlane.perlane_closest_sweep_ref(
                ts, rays, TMIN, st0.clone(), counts=work.setdefault("K1", {}))),
            ("K10a", traverse.closest_sweep_ref(ts, rays, TMIN, st0.clone()))):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name_
    hit = got[traverse.ST_VALID].view(torch.int32) != 0
    assert 0.02 < hit.float().mean() < 0.9
    live = int((win > TMIN).sum())
    # not asserted: cone rays are incoherent, warps vote for nodes few of
    # their lanes need
    print({k: {n: v / live for n, v in c.items()} for k, c in work.items()},
          "per live ray")

    tmax = torch.from_numpy(np.where(
        win > 0, np.random.default_rng(4).uniform(0, 25, win.shape), 0
    ).astype(np.float32))
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32)
    occ0[3, ::7] = 1                                  # OR-merge keeps these
    want = traverse.anyhit_sweep_ref(ts, rays, TMIN, tmax, occ0.clone())
    assert (want != occ0).any()
    for order in ("light", "origin"):
        for occ in (consensus.mega_anyhit_sweep_ref(ts, rays, TMIN, tmax,
                                                    occ0.clone(), order),
                    perlane.perlane_anyhit_sweep_ref(ts, rays, TMIN, tmax,
                                                     occ0.clone(), order)):
            assert torch.equal(occ, want), order


def test_consensus_counts_its_groups():
    """The plain consensus walk counts a box test for every live lane of a
    group at every node the group visits: a group of one lane is the
    per-lane walk with leaf box tests, which visits no more nodes than a
    group of 32 and tests no more triangles, and both find the same hits."""
    ts = _scene("mixed")
    rays, win = (torch.from_numpy(x) for x in cone_rays(2, seed=5))
    st0 = traverse.make_trace_state(win)
    rows, walks, links = perlane.plain_schedule(
        ts, rays, win, TMIN, "origin", consensus.wide_links(ts))
    counts, states = {}, {}
    for group in (1, consensus.WARP):
        counts[group] = {}
        states[group] = traverse.closest_ref(ts, rays, TMIN, st0.clone(), rows,
                                             walks, links, counts=counts[group],
                                             consensus=group)
    assert torch.equal(states[1].view(torch.int32),
                       states[consensus.WARP].view(torch.int32))
    assert 0 < counts[1]["nodes"] < counts[consensus.WARP]["nodes"]
    assert 0 < counts[1]["tests"] < counts[consensus.WARP]["tests"]


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_standin_frame_consensus_equals_chained(name):
    """The stand-ins resolve to the consensus tier, and its frame equals
    the chained tier's bit for bit (the tie check's bar, n_diff 0)."""
    r = Renderer(STANDINS[name](16, width=96, height=64), "cpu")
    ts = r.tscene
    assert (ts.traversal, ts.auto_tier) == ("auto", "mega")
    imgs = {}
    for trav in ("auto", "pallas"):
        stats = {}
        imgs[trav] = render_frame(dataclasses.replace(ts, traversal=trav),
                                  r.render_static, r.camera_tensor(),
                                  stats=stats)
        assert stats["tier"] == {"auto": "mega"}.get(trav, trav)
        if trav == "auto":
            rays = int(stats["closest_rays"])
        else:
            assert int(stats["closest_rays"]) == rays
    assert imgs["auto"].std() > 0.05
    assert torch.equal(imgs["auto"], imgs["pallas"])


def _standin_same_rays_frames(name):
    """(port frame, raytpu frame) of a 64x48 stand-in at its spp and bounce
    cap from the same primary rays (``test_torch_frame._same_rays_frames``),
    the port's on the consensus tier."""
    make = STANDINS[name]
    cfg = make(16).config

    def scene_fn(width, height, spp, bounces):
        return make(16, width=width, height=height, samples_per_pixel=spp,
                    max_bounce_count=bounces)

    return _same_rays_frames(64, 48, cfg.samples_per_pixel,
                             cfg.max_bounce_count, scene_fn=scene_fn,
                             tier="mega")


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_standin_same_rays_frame_matches_raytpu(name, tmp_path):
    """From the same primary rays, the port's consensus-tier frame of a
    stand-in against raytpu's frame (its XLA bounce body): within 1e-5 per
    pixel, SSIM > 0.98. Both render in a child process whose XLA:CPU has no
    fused multiply-add (``--xla_cpu_max_isa=AVX``, as in
    ``test_torch_traverse.py``): with FMA, the mirror bounces of config2
    amplify the chain's other rounding to 2.0e-5 on 2 of 9,216 values."""
    out = tmp_path / "frames.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, name, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    frames = np.load(out)
    got, want = frames["got"], frames["want"]
    assert got.shape == want.shape == (48, 64, 3)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ssim(got, want) > 0.98


if __name__ == "__main__":
    # both frames, in a process whose XLA_FLAGS the parent set
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    got, want = _standin_same_rays_frames(sys.argv[1])
    np.savez(sys.argv[2], got=got, want=want)
