"""Ray-primitive tests (counterpart of ``raytpu/ops/intersect.py``), in the
per-lane form the traversal walk uses: each lane carries its own triangle
or node, so every operand is a same-shape tensor, and the operations follow
``raytpu/ops/traverse_pallas.py::_mt`` (:83-112) and ``::_slab`` (:70-80)
in order. The CUDA helpers in ``csrc/common.cuh`` are the same functions.

The brute-force tracers (``raytpu/ops/intersect.py:147-265``), which walk
no tree: every ray against every triangle of a table. They are the JAX
package's BVH-free path (``traversal="brute"`` or ``bvh_builder="brute"``)
and its correctness oracle. ``brute_closest`` / ``brute_anyhit`` are the
kernel wrappers: a CPU tensor takes the plain version beside them
(``brute_closest_ref`` / ``brute_anyhit_ref``, a block scan over the
triangles with :func:`moller_trumbore`, as raytpu's ``lax.scan`` over
blocks), a CUDA tensor launches ``brute_closest_kernel`` /
``brute_anyhit_kernel`` of ``csrc/brute.cu`` (or raises). The triangles
are the packed (T, 12) f32 records ``{v0, 0}, {e1, 0}, {e2, 0}`` in
primitive order (``TorchScene.tri_packed``). Among hits at equal t the
lowest triangle index wins: raytpu's block ``argmin`` keeps the first of a
block and its merge across blocks is strict, and the closest kernel scans
in index order with a strict ``t < best_t``. Occlusion has no order: a
lane is occluded iff some triangle passes its test, so the any-hit kernel
scans each ray's triangles as a ring from wherever its warp stands.
"""

from __future__ import annotations

import torch

from raytpu_torch import _build

DET_EPS = 1e-9
BIG_T = 3.0e38  # "no hit" distance
# triangles a step of the plain brute scan tests against every ray
# (raytpu's ``block``), and the (rays x triangles) elements one step's
# temporaries may hold: the scan takes the rays in chunks under it
BRUTE_BLOCK = 512
BRUTE_ELEMS = 1 << 22
# brute_anyhit_kernel's grid (csrc/brute.cu): a ray ring of at least
# ANYHIT_RING_TILES tiles of 32 triangles takes a persistent grid of
# ANYHIT_CTAS_PER_SM CTAs an SM, fewer than fit; a shorter one a thread a
# ray. CTAs are ANYHIT_THREADS threads (rt::BLOCK).
ANYHIT_RING_TILES = 12
ANYHIT_CTAS_PER_SM = 1
ANYHIT_THREADS = 256


def safe_inverse(d: torch.Tensor) -> torch.Tensor:
    """1/d with +-inf for zero components (slab-test convention)."""
    inf = torch.full_like(d, float("inf"))
    return torch.where(d != 0.0, 1.0 / d, torch.where(d >= 0, inf, -inf))


def moller_trumbore(o, d, v0, e1, e2, tmin: float, best_t: torch.Tensor):
    """Double-sided Moller-Trumbore with a strict ``t < best_t``; all
    operands per lane (Vec3 tuples of (L,) tensors). Returns
    ``(t, u, v, hit)``."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = torch.abs(det) > DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvx = o[0] - v0[0]
    tvy = o[1] - v0[1]
    tvz = o[2] - v0[2]
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1[2] - tvz * e1[1]
    qy = tvz * e1[0] - tvx * e1[2]
    qz = tvx * e1[1] - tvy * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < best_t)
    return t, u, v, hit


def slab_near(o, d_inv, bmin, bmax, tmin: float, tfar_cap: torch.Tensor):
    """Slab test per lane, ``(hit, t_near)``: t_near is the box's entry
    distance ``max(slab entries, tmin)`` (``csrc/common.cuh``'s
    ``slab_near``). ``torch.minimum``/``maximum`` propagate NaN, as
    ``jnp.minimum``/``maximum`` do in ``_slab``: a 0*inf NaN makes the test
    false and the node is skipped (``intersect.ray_aabb`` differs on
    purpose; the packed kernels and this walk share the ``_slab`` rule)."""
    tmin_t = torch.full_like(tfar_cap, tmin)
    tns, tfs = [], []
    for a in range(3):
        lo = (bmin[a] - o[a]) * d_inv[a]
        hi = (bmax[a] - o[a]) * d_inv[a]
        tns.append(torch.minimum(lo, hi))
        tfs.append(torch.maximum(lo, hi))
    t_near = torch.maximum(torch.maximum(tns[0], tns[1]), torch.maximum(tns[2], tmin_t))
    t_far = torch.minimum(torch.minimum(tfs[0], tfs[1]), torch.minimum(tfs[2], tfar_cap))
    return t_near <= t_far, t_near


def slab(o, d_inv, bmin, bmax, tmin: float, tfar_cap: torch.Tensor) -> torch.Tensor:
    """Slab test per lane (:func:`slab_near`'s hit)."""
    return slab_near(o, d_inv, bmin, bmax, tmin, tfar_cap)[0]


# ---------------------------------------------------------------------------
# brute-force tracers
# ---------------------------------------------------------------------------

def _brute_lanes(rays: torch.Tensor, tmax: torch.Tensor, tmin: float):
    """The live lanes (window above ``tmin``) of a brute query: their
    indices into the flattened lanes, rays and windows. A dead lane can hit
    nothing (``tmin < t < tmax`` is empty), so it is not tested."""
    rflat = rays.reshape(6, -1)
    tflat = tmax.reshape(-1)
    live = (tflat > tmin).nonzero().squeeze(1)
    return live, rflat[:, live], tflat[live]


def _tri_block(tris: torch.Tensor, b0: int, block: int):
    """Triangles ``b0 .. b0 + block`` of the packed table as (1, B) Vec3s
    ``(v0, e1, e2)``."""
    tb = tris[b0:b0 + block]
    return tuple(tuple(tb[None, :, 4 * w + c] for c in range(3))
                 for w in range(3))


def _ray_chunk(n_tris: int, block: int) -> int:
    return max(1, BRUTE_ELEMS // max(1, min(block, n_tris)))


def brute_closest_ref(rays: torch.Tensor, tmax: torch.Tensor,
                      tris: torch.Tensor, tmin: float,
                      block: int = BRUTE_BLOCK):
    """Plain PyTorch :func:`brute_closest`: per block of ``block``
    triangles, every (ray, triangle) test at once, the block's first
    least-t hit by ``argmin``, merged where it improves (raytpu's
    ``brute_closest`` :163, without its padding triangles, which no ray
    hits). The rays go in chunks so that one step's (rays x triangles)
    temporaries stay under :data:`BRUTE_ELEMS` elements."""
    shape, dev = rays.shape[1:], rays.device
    n = tmax.numel()
    t_out = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((n,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((n,), dtype=torch.float32, device=dev)
    live, r, tm = _brute_lanes(rays, tmax, tmin)
    n_tris = tris.shape[0]
    step = _ray_chunk(n_tris, block)
    for s in range(0, live.numel(), step):
        o = tuple(r[c, s:s + step, None] for c in range(3))
        d = tuple(r[3 + c, s:s + step, None] for c in range(3))
        best_t = tm[s:s + step].clone()
        best_p = torch.full_like(best_t, -1, dtype=torch.int32)
        best_u = torch.zeros_like(best_t)
        best_v = torch.zeros_like(best_t)
        for b0 in range(0, n_tris, block):
            t, u, v, hit = moller_trumbore(o, d, *_tri_block(tris, b0, block),
                                           tmin, best_t[:, None])
            t = torch.where(hit, t, BIG_T)
            arg = t.argmin(dim=1, keepdim=True)
            better = hit.any(dim=1)
            best_t = torch.where(better, t.gather(1, arg)[:, 0], best_t)
            best_u = torch.where(better, u.gather(1, arg)[:, 0], best_u)
            best_v = torch.where(better, v.gather(1, arg)[:, 0], best_v)
            best_p = torch.where(better, (arg[:, 0] + b0).to(torch.int32),
                                 best_p)
        lanes = live[s:s + step]
        t_out[lanes] = torch.where(best_p >= 0, best_t, BIG_T)
        prim[lanes] = best_p
        u_out[lanes] = best_u
        v_out[lanes] = best_v
    return (t_out.reshape(shape), prim.reshape(shape), u_out.reshape(shape),
            v_out.reshape(shape))


def brute_anyhit_ref(rays: torch.Tensor, tmax: torch.Tensor,
                     tris: torch.Tensor, tmin: float,
                     block: int = BRUTE_BLOCK) -> torch.Tensor:
    """Plain PyTorch :func:`brute_anyhit`: per block, every pending lane's
    tests at once, OR-merged (raytpu's ``brute_anyhit`` :226) -> bool of
    the lanes' shape. A lane stops being tested once it is occluded."""
    shape, dev = rays.shape[1:], rays.device
    occ = torch.zeros(tmax.numel(), dtype=torch.bool, device=dev)
    live, r, tm = _brute_lanes(rays, tmax, tmin)
    n_tris = tris.shape[0]
    step = _ray_chunk(n_tris, block)
    for s in range(0, live.numel(), step):
        idx = torch.arange(s, min(s + step, live.numel()), device=dev)
        for b0 in range(0, n_tris, block):
            if idx.numel() == 0:
                break
            o = tuple(r[c, idx, None] for c in range(3))
            d = tuple(r[3 + c, idx, None] for c in range(3))
            _, _, _, hit = moller_trumbore(o, d, *_tri_block(tris, b0, block),
                                           tmin, tm[idx, None])
            found = hit.any(dim=1)
            occ[live[idx[found]]] = True
            idx = idx[~found]
    return occ.reshape(shape)


def _brute_operands(kernel: str, rays: torch.Tensor, tmax: torch.Tensor,
                    tris: torch.Tensor):
    """Validated pointers of a brute launch: the ray planes and their
    stride, the windows and the packed triangles (16-byte aligned)."""
    shape = rays.shape[1:]
    rp = _build.check_planes(kernel, "rays", rays, (6, *shape))
    tp = _build.check_operand(kernel, "tmax", tmax, shape)
    trp = _build.check_operand(kernel, "tris", tris, (tris.shape[0], 12))
    if trp % 16:
        raise ValueError(f"{kernel}: the triangle records are not 16-byte "
                         "aligned")
    return (*rp, tp, trp, tris.shape[0])


def brute_closest(rays: torch.Tensor, tmax: torch.Tensor, tris: torch.Tensor,
                  tmin: float):
    """Closest hit of ``rays`` (6, ...) within ``(tmin, tmax)`` per lane
    against every triangle of ``tris`` (T, 12) -> ``(t, prim, u, v)`` of
    the lanes' shape: t ``BIG_T``, prim -1 and u, v 0 on a miss; prim
    indexes ``tris``. CPU tensors take :func:`brute_closest_ref`; CUDA
    tensors launch ``brute_closest_kernel``."""
    if rays.device.type == "cpu":
        return brute_closest_ref(rays, tmax, tris, tmin)
    k = "brute_closest"
    shape = rays.shape[1:]
    out = torch.empty((3, *shape), dtype=torch.float32, device=rays.device)
    prim = torch.empty(shape, dtype=torch.int32, device=rays.device)
    _build.launch(k, *_brute_operands(k, rays, tmax, tris), tmax.numel(),
                  float(tmin), out.data_ptr(), out.stride(0), prim.data_ptr())
    return out[0], prim, out[1], out[2]


def anyhit_grid(n: int, n_tris: int, device) -> int:
    """The CTAs of ``brute_anyhit_kernel``'s launch for ``n`` rays against
    ``n_tris`` triangles on ``device``: one thread a ray, and no more than
    :data:`ANYHIT_CTAS_PER_SM` a multiprocessor once a ray's ring has
    :data:`ANYHIT_RING_TILES` tiles or more (on the H100 the persistent
    grid wins from 384 triangles up, the flat one below)."""
    grid = max(1, -(-n // ANYHIT_THREADS))
    if -(-n_tris // 32) < ANYHIT_RING_TILES:
        return grid
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(grid, sms * ANYHIT_CTAS_PER_SM)


def brute_anyhit(rays: torch.Tensor, tmax: torch.Tensor, tris: torch.Tensor,
                 tmin: float) -> torch.Tensor:
    """Occlusion of ``rays`` (6, ...) within ``(tmin, tmax)`` per lane by
    any triangle of ``tris`` -> bool of the lanes' shape. CPU tensors take
    :func:`brute_anyhit_ref`; CUDA tensors launch ``brute_anyhit_kernel``:
    warps (:func:`anyhit_grid`) whose lanes each own a ray, walk the
    triangles as a ring of 32-triangle tiles from the tile their warp is
    on, and take the next ray from a counter (zeroed here) once theirs is
    occluded or has met every triangle."""
    if rays.device.type == "cpu":
        return brute_anyhit_ref(rays, tmax, tris, tmin)
    k = "brute_anyhit"
    occ = torch.empty(rays.shape[1:], dtype=torch.int32, device=rays.device)
    counter = torch.zeros(1, dtype=torch.int32, device=rays.device)
    n = tmax.numel()
    _build.launch(k, *_brute_operands(k, rays, tmax, tris), n, float(tmin),
                  occ.data_ptr(), counter.data_ptr(),
                  anyhit_grid(n, tris.shape[0], rays.device))
    return occ != 0


def kernel_attributes() -> dict:
    """The brute kernels' registers, local bytes, resident CTAs and SMs
    (:func:`raytpu_torch._build.kernel_attributes`)."""
    return _build.kernel_attributes("rt_brute_attributes",
                                    ("brute_closest", "brute_anyhit"))
