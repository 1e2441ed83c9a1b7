"""The brute any-hit tracer's freedom of order, held on the CPU: the
invariant ``brute_anyhit_kernel`` (``raytpu_torch/csrc/brute.cu``) leans
on, and its schedule.

* On seeded triangle soups of 1, 31, 32, 33 and 300 triangles (some of
  them copies of others) with dead lanes, ``brute_anyhit_ref`` gives the
  same flags on the original order, on a permutation and on every tested
  ring rotation of the triangles, and the same as raytpu's
  ``brute_anyhit``: a lane is occluded iff some triangle passes its test,
  whatever the order of the tests.
* :func:`may_occlude_ref`, a plain copy of the kernel's candidate filter
  (``may_occlude``: a necessary condition for a hit from the test's
  operations before its division), passes every (ray, triangle) pair that
  ``moller_trumbore`` hits, on soups at scales from 1e-3 to 1e12 with
  rays aimed at vertices, edges and points just beside them, and passes
  over most of the pairs it does not hit.
* :func:`emulate_anyhit`, a plain emulation of the kernel's schedule that
  lives here only (warps whose lanes take their own ray first, then refill
  from a counter at tile boundaries, each ray's ring starting at its
  warp's current tile, a partial last tile, warps that outlive the rays),
  equals
  ``brute_anyhit_ref`` lane for lane, and tests every triangle of an
  unoccluded ray exactly once.

raytpu's side runs in a child process whose XLA:CPU has no fused
multiply-add (``--xla_cpu_max_isa=AVX``, as in ``test_torch_knobs.py``):
the port rounds every operation once.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytpu.ops import intersect as jint
from raytpu_torch.device_scene import pack_tris
from raytpu_torch.ops import intersect

NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent
TMIN = 1e-3
SEEDS = (0, 1, 2)
TRIANGLES = (1, 31, 32, 33, 300)
TILE = 32    # triangles a tile of the kernel's ring (csrc/brute.cu kTile)
WARP = 32


def _soup(seed: int, n_tris: int):
    """``n_tris`` seeded triangles around the origin (the last fifth copies
    of others: a ray that hits one hits its copy), larger the fewer they
    are, and 700 rays from a shell aimed inside: every seventh lane dead
    (window 0), lane 5 with a window under ``TMIN``, the others varied."""
    rng = np.random.default_rng(1000 * seed + n_tris)
    n_dup = n_tris // 5
    n = n_tris - n_dup
    scale = 0.8 * max(1.0, (300 / n_tris) ** 0.5)
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e1 = rng.normal(scale=scale, size=(n, 3)).astype(np.float32)
    e2 = rng.normal(scale=scale, size=(n, 3)).astype(np.float32)
    dup = rng.choice(n, n_dup, replace=n_dup > n)
    v0, e1, e2 = (np.concatenate([x, x[dup]]) for x in (v0, e1, e2))
    r = 700
    u = rng.normal(size=(r, 3))
    o = (u / np.linalg.norm(u, axis=1, keepdims=True) * 8.0).astype(np.float32)
    d = (rng.uniform(-2, 2, (r, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(4.0, 14.0, r).astype(np.float32)
    tmax[::7] = 0.0
    tmax[5] = TMIN / 2
    return v0, e1, e2, o, d, tmax


def _port_soup(seed: int, n_tris: int):
    v0, e1, e2, o, d, tmax = _soup(seed, n_tris)
    rays = torch.from_numpy(np.ascontiguousarray(np.concatenate([o.T, d.T])))
    tris = pack_tris(*(torch.from_numpy(x) for x in (v0, e1, e2)))
    return rays, torch.from_numpy(tmax), tris


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """raytpu's ``brute_anyhit`` flags of every soup, computed in one child
    process without FMA."""
    out = tmp_path_factory.mktemp("brute") / "brute.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("n_tris", TRIANGLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_anyhit_matches_raytpu(child, seed, n_tris):
    rays, tmax, tris = _port_soup(seed, n_tris)
    occ = intersect.brute_anyhit(rays, tmax, tris, TMIN)
    np.testing.assert_array_equal(occ.numpy(), child[f"occ{seed}_{n_tris}"])
    assert occ.any() and not occ.all()
    assert not occ[::7].any() and not occ[5]


@pytest.mark.parametrize("n_tris", TRIANGLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_anyhit_is_order_free(seed, n_tris):
    """The flags on a permutation and on ring rotations of the triangles
    (by one, by a tile, by half and by all but one) equal the flags on
    the original order."""
    rays, tmax, tris = _port_soup(seed, n_tris)
    want = intersect.brute_anyhit_ref(rays, tmax, tris, TMIN)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n_tris))
    assert torch.equal(intersect.brute_anyhit_ref(rays, tmax, tris[perm], TMIN),
                       want)
    for shift in sorted({1, TILE, n_tris // 2, n_tris - 1}):
        rolled = torch.roll(tris, shift % n_tris, dims=0)
        assert torch.equal(intersect.brute_anyhit_ref(rays, tmax, rolled, TMIN),
                           want), shift


def may_occlude_ref(o, d, v0, e1, e2):
    """The kernel's ``may_occlude`` (``csrc/brute.cu``) on Vec3 tuples of
    same-shape tensors: ``moller_trumbore``'s operations up to the
    numerators of u and v, then the same comparisons."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    tvx = o[0] - v0[0]
    tvy = o[1] - v0[1]
    tvz = o[2] - v0[2]
    qx = tvy * e1[2] - tvz * e1[1]
    qy = tvz * e1[0] - tvx * e1[2]
    qz = tvx * e1[1] - tvy * e1[0]
    su = tvx * px + tvy * py + tvz * pz
    sv = d[0] * qx + d[1] * qy + d[2] * qz
    neg = det < 0.0
    su, sv = torch.where(neg, -su, su), torch.where(neg, -sv, sv)
    ad = det.abs()
    small = ad * 2.0 ** -60
    keep = (su > -small) & (sv > -small) & ~(
        (su >= 0.0) & (sv >= 0.0) & (su + sv > ad * (1.0 + 2.0 ** -16)))
    return (ad > intersect.DET_EPS) & (~(ad < 2.0 ** 100) | keep)


@pytest.mark.parametrize("scale", (1e-3, 1.0, 1e4, 1e12))
@pytest.mark.parametrize("seed", SEEDS)
def test_candidate_filter_keeps_every_hit(seed, scale):
    """Every (ray, triangle) pair of a scaled 300-triangle soup that
    ``moller_trumbore`` hits with an open window (tmin -3e38, tmax inf, so
    only its det, u and v conditions decide) is a candidate of
    :func:`may_occlude_ref`: the soup's rays, and rays aimed at each
    triangle's vertices, edge points and points 1e-7 beside them. At scale
    1 the filter passes over most pairs."""
    v0, e1, e2, o, d, _ = _soup(seed, 300)
    rng = np.random.default_rng(seed)
    ab = np.array([(0, 0), (1, 0), (0, 1), (0.5, 0.5), (0.3, 0), (0, 0.3),
                   (0.5 + 1e-7, 0.5), (-1e-7, 0.4), (0.4, -1e-7)])
    aim = (v0[:, None] + ab[None, :, :1] * e1[:, None]
           + ab[None, :, 1:] * e2[:, None]).reshape(-1, 3)
    u = rng.normal(size=(aim.shape[0], 3))
    start = u / np.linalg.norm(u, axis=1, keepdims=True) * 8.0
    toward = aim - start
    toward /= np.linalg.norm(toward, axis=1, keepdims=True)
    o = np.concatenate([o, start]) * scale
    d = np.concatenate([d, toward])

    def vec(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
        return tuple(x[..., c] for c in range(3))

    ro, rd = vec(o[:, None]), vec(d[:, None])
    tri = [vec(x[None] * scale) for x in (v0, e1, e2)]
    hit = intersect.moller_trumbore(ro, rd, *tri, -3e38,
                                    torch.full(ro[0].shape, float("inf")))[3]
    maybe = may_occlude_ref(ro, rd, *tri)
    assert hit.sum() > 1000
    assert not (hit & ~maybe).any()
    if scale == 1.0:
        assert maybe.float().mean() < 0.2


def emulate_anyhit(rays, tmax, tris, tmin: float, warps: int):
    """The schedule of ``brute_anyhit_kernel``, one warp iteration at a
    time, the warps taking turns: each lane owns a ray, lane ``k`` of warp
    ``w`` first ray ``32 w + k``; at the top of an iteration the warp's
    free lanes take the next rays from a counter past the grid's lanes
    (one take a warp, handed out in lane order); a dead ray (window not
    above ``tmin``) is written 0 and its lane takes again; the warp tests
    its current tile of :data:`TILE` triangles (the last one partial) on
    every lane that holds a ray and steps to the next tile of the ring; a
    lane's ray ends at its first hit or after every tile, and the warp
    leaves when the counter is spent and its lanes are free. Warp ``w``
    starts at tile ``w`` of the ring. Returns the flags (-1 where none was
    written) and how often each (ray, triangle) pair was tested."""
    from raytpu_torch.ops.intersect import moller_trumbore

    rflat, tflat = rays.reshape(6, -1), tmax.reshape(-1)
    n, n_tris = tflat.numel(), tris.shape[0]
    n_tiles = max(1, -(-n_tris // TILE))
    occ = torch.full((n,), -1, dtype=torch.int32)
    tested = torch.zeros((n, n_tris), dtype=torch.int32)
    threads = warps * WARP
    counter = 0

    def take(s, k, i):
        if i < n and tflat[i] > tmin:
            s["ray"][k], s["left"][k] = i, n_tiles
        elif i < n:
            occ[i] = 0

    state = []
    for w in range(warps):
        s = {"cur": w % n_tiles, "ray": [-1] * WARP, "left": [0] * WARP,
             "more": threads < n}
        for k in range(WARP):
            take(s, k, w * WARP + k)
        state.append(s)
    while state:
        for s in list(state):
            while s["more"]:
                free = [k for k in range(WARP) if s["ray"][k] < 0]
                if not free:
                    break
                base, counter = threads + counter, counter + len(free)
                s["more"] = base + len(free) < n
                for j, k in enumerate(free):
                    take(s, k, base + j)
            lanes = [k for k in range(WARP) if s["ray"][k] >= 0]
            if not lanes:
                state.remove(s)
                continue
            lo = s["cur"] * TILE
            hi = min(n_tris, lo + TILE)
            idx = torch.tensor([s["ray"][k] for k in lanes])
            corner = [tuple(tris[None, lo:hi, 4 * w + c] for c in range(3))
                      for w in range(3)]
            hit = moller_trumbore(tuple(rflat[c, idx, None] for c in range(3)),
                                  tuple(rflat[3 + c, idx, None] for c in range(3)),
                                  *corner, tmin, tflat[idx, None])[3].any(dim=1)
            tested[idx, lo:hi] += 1
            for j, k in enumerate(lanes):
                if not hit[j]:
                    s["left"][k] -= 1
                if hit[j] or s["left"][k] == 0:
                    occ[s["ray"][k]] = int(hit[j])
                    s["ray"][k] = -1
            s["cur"] = (s["cur"] + 1) % n_tiles
    assert threads + counter >= n
    return occ, tested


@pytest.mark.parametrize("warps", (1, 4, 40))
@pytest.mark.parametrize("n_tris", TRIANGLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_equals_plain(seed, n_tris, warps):
    """The emulated schedule writes every lane once, equals
    ``brute_anyhit_ref`` lane for lane, tests an unoccluded ray against
    every triangle exactly once and an occluded one against each at most
    once, and never tests a dead lane. 40 warps hold more lanes than the
    700 rays (the kernel's flat grid): some never get one, and no lane
    takes a second ray."""
    rays, tmax, tris = _port_soup(seed, n_tris)
    want = intersect.brute_anyhit_ref(rays, tmax, tris, TMIN)
    occ, tested = emulate_anyhit(rays, tmax, tris, TMIN, warps)
    assert (occ >= 0).all()
    assert torch.equal(occ != 0, want)
    live = tmax > TMIN
    assert (tested[~live] == 0).all()
    assert (tested[live & ~want] == 1).all()
    assert (tested[want] <= 1).all() and (tested[want].sum(dim=1) >= 1).all()


@pytest.mark.parametrize("n_tris", (1, 32, 32 * (intersect.ANYHIT_RING_TILES - 1)))
def test_anyhit_grid_is_flat_on_short_rings(n_tris):
    """A ring of fewer than ``ANYHIT_RING_TILES`` tiles takes one thread a
    ray (no card is asked); no launch has fewer than one CTA."""
    assert intersect.anyhit_grid(1000, n_tris, "cpu") == 4
    assert intersect.anyhit_grid(0, n_tris, "cpu") == 1


if __name__ == "__main__":
    # raytpu's side, in a process whose XLA_FLAGS the parent set
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for seed in SEEDS:
        for n_tris in TRIANGLES:
            v0, e1, e2, o, d, tmax = _soup(seed, n_tris)
            out[f"occ{seed}_{n_tris}"] = np.asarray(
                jint.brute_anyhit(o, d, v0, e1, e2, TMIN, tmax))
    np.savez(sys.argv[1], **out)
