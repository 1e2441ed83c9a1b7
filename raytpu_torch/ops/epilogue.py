"""Fused shade and accumulate passes of the bounce loop (counterpart of
``raytpu/ops/epilogue.py``, the Pallas kernels K3 ``_shade_kernel`` and K4
``_acc_kernel``), on the packed ABI of ``ops/traverse.py``: rays (6, P, K),
trace state (9, P, K) in ``ST_*`` order, int32 (P, K) flags.

``shade_epilogue`` / ``accumulate_epilogue`` are the kernel wrappers: a CPU
tensor takes the plain version beside them, a CUDA tensor launches the
kernel in ``csrc/epilogue.cu`` (or raises). The plain versions follow K3's
and K4's operations line by line (``epilogue.py:99-189`` and ``:245-259``),
in the same order, with the same constants.

Both passes update in place, as the JAX package aliases the buffers
(``epilogue.py:232,293``): the shade pass writes the continuation rays over
``rays`` and the new miss flags over ``miss``; the accumulate pass adds into
``tmp``. One thread (one lane of the plain version) reads all of its
lane's inputs before it writes, so this is safe. Multi-plane operands may
be waves ``x[:, s:s+b]`` of larger buffers.
"""

from __future__ import annotations

import torch

from raytpu_torch import _build
from raytpu_torch.config import (
    DIFFUSE_COEFF,
    HIT_EPSILON,
    INDEX_OF_REFRACTION,
    RAY_TMAX,
    SPECULAR_COEFF,
    SPECULAR_EXPONENT,
)
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.traverse import ST_MAT, ST_NX, ST_T, ST_VALID

# packets per grid step of the JAX kernels (epilogue.py:79). The CUDA
# kernels have no block granule; the bounce loop keeps the JAX package's
# ``budget % BP`` rule so that both packages run the same wave schedule.
BP = 16


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded correctly, as ``sqrtf`` on the card and
    XLA's on the CPU round it: by way of float64, whose root rounds to the
    same f32. (PyTorch's CPU ``sqrt`` of f32 is off by one ulp on some
    inputs: 220 of 32,768 lanes of the epilogue test's normals.)"""
    return torch.sqrt(x.double()).float()


def _inv_norm(x):
    """``1 / max(sqrt(max(x.x, 0)), 1e-30)`` as K3 computes it."""
    s = v3.dot(x, x)
    return 1.0 / torch.clamp_min(_sqrt(torch.clamp_min(s, 0.0)), 1e-30)


def shade_epilogue_ref(rays, state, miss, light_pos, light_intensity):
    """Plain :func:`shade_epilogue`: the operations of ``_shade_kernel``
    (``raytpu/ops/epilogue.py:99-189``) in order."""
    o = [rays[c] for c in range(3)]
    d = [rays[3 + c] for c in range(3)]
    t = state[ST_T]
    valid = state[ST_VALID].view(torch.int32) != 0
    mat = state[ST_MAT].view(torch.int32)

    # post-sweep t > 0 is the pre-sweep active mask (:105-108)
    active = t > 0.0
    hit = valid
    miss_new = miss | (active & ~valid).to(torch.int32)

    n = [state[ST_NX + c] for c in range(3)]
    inv_len = _inv_norm(n)
    n = [c * inv_len for c in n]

    pos = [o[c] + t * d[c] for c in range(3)]
    is_diffuse = hit & (mat == 0)
    is_mirror = hit & (mat == 1)

    d_dot_n = v3.dot(d, n)
    lit = is_diffuse & (d_dot_n < 0.0)            # backface break

    to_l = [light_pos[c] - pos[c] for c in range(3)]
    dist = _sqrt(torch.clamp_min(v3.dot(to_l, to_l), 0.0))
    inv_dist = 1.0 / torch.clamp_min(dist, 1e-30)
    l = [inv_dist * c for c in to_l]
    srays = torch.stack([pos[c] + HIT_EPSILON * n[c] for c in range(3)] + l)
    swin = torch.where(lit, dist, 0.0)

    # Blinn-Phong scalars; view = -d
    h = [l[c] - d[c] for c in range(3)]
    inv_h = _inv_norm(h)
    h = [c * inv_h for c in h]
    ndotl = torch.clamp_min(v3.dot(n, l), 0.0)
    ndoth = torch.clamp_min(v3.dot(n, h), 0.0)
    ab = torch.stack([ndotl, ndoth ** SPECULAR_EXPONENT])

    # mirror continuation
    refl = [d[c] - 2.0 * d_dot_n * n[c] for c in range(3)]
    o_m = [pos[c] + HIT_EPSILON * n[c] for c in range(3)]

    # refractive continuation with Snell + TIR
    outwards = d_dot_n > 0.0
    n_f = [torch.where(outwards, -n[c], n[c]) for c in range(3)]
    ndoti_f = torch.where(outwards, -d_dot_n, d_dot_n)
    ratio = torch.where(outwards, torch.full_like(t, INDEX_OF_REFRACTION),
                        torch.full_like(t, 1.0 / INDEX_OF_REFRACTION))
    kk = 1.0 - ratio * ratio * (1.0 - ndoti_f * ndoti_f)
    tir = kk < 0.0
    dn_f = v3.dot(d, n_f)
    d_tir = [d[c] - 2.0 * dn_f * n_f[c] for c in range(3)]
    o_tir = [pos[c] + HIT_EPSILON * n_f[c] for c in range(3)]
    coeff = ratio * ndoti_f + _sqrt(torch.clamp_min(kk, 0.0))
    r = [ratio * d[c] - coeff * n_f[c] for c in range(3)]
    inv_r = _inv_norm(r)
    r = [c * inv_r for c in r]
    o_ref = [pos[c] - HIT_EPSILON * n_f[c] for c in range(3)]
    o_r = [torch.where(tir, o_tir[c], o_ref[c]) for c in range(3)]
    d_r = [torch.where(tir, d_tir[c], r[c]) for c in range(3)]

    cont = is_mirror | (hit & (mat == 2))
    nrays = torch.stack(
        [torch.where(cont, torch.where(is_mirror, o_m[c], o_r[c]), o[c])
         for c in range(3)]
        + [torch.where(cont, torch.where(is_mirror, refl[c], d_r[c]), d[c])
           for c in range(3)])
    nwin = torch.where(cont, RAY_TMAX, 0.0)
    rays.copy_(nrays)
    miss.copy_(miss_new)
    return srays, swin, ab, lit.to(torch.int32), rays, nwin, miss


def accumulate_epilogue_ref(occ, ab, lit, tmp, decay_p, light_pos,
                            light_intensity):
    """Plain :func:`accumulate_epilogue`: the operations of ``_acc_kernel``
    (``raytpu/ops/epilogue.py:245-259``)."""
    shade = (lit != 0) & (occ == 0)
    a, b = ab[0], ab[1]
    decay = decay_p[:, None]
    for c in range(3):
        phong = light_intensity * (DIFFUSE_COEFF[c] * a + SPECULAR_COEFF[c] * b)
        tmp[c] = tmp[c] + torch.where(shade, decay * phong, 0.0)
    return tmp


def shade_epilogue(rays: torch.Tensor, state: torch.Tensor, miss: torch.Tensor,
                   light_pos, light_intensity: float):
    """Post-closest-sweep body of one bounce: ``rays`` (6, P, K), ``state``
    (9, P, K), int32 ``miss`` (P, K), the light as host floats ->
    ``(srays, swin, ab, lit, nrays, nwin, miss')``: shadow rays (6, P, K)
    and windows, Blinn-Phong ``ndotl`` / ``ndoth**100`` (2, P, K), int32
    lit candidates, continuation rays (written over ``rays``), next windows,
    miss flags (written over ``miss``). CPU tensors take
    :func:`shade_epilogue_ref`; CUDA tensors launch ``rt_shade_epilogue``."""
    if rays.device.type == "cpu":
        return shade_epilogue_ref(rays, state, miss, light_pos,
                                  light_intensity)
    k = "shade_epilogue"
    lanes = tuple(rays.shape[1:])
    dev = rays.device
    srays = torch.empty((6, *lanes), dtype=torch.float32, device=dev)
    swin = torch.empty(lanes, dtype=torch.float32, device=dev)
    ab = torch.empty((2, *lanes), dtype=torch.float32, device=dev)
    lit = torch.empty(lanes, dtype=torch.int32, device=dev)
    nwin = torch.empty(lanes, dtype=torch.float32, device=dev)
    rays_p = _build.check_planes(k, "rays", rays, (6, *lanes))
    miss_p = _build.check_operand(k, "miss", miss, lanes, torch.int32)
    _build.launch(
        k, *rays_p,
        *_build.check_planes(k, "state", state, (9, *lanes)),
        miss_p,
        *_build.check_planes(k, "srays", srays, (6, *lanes)),
        _build.check_operand(k, "swin", swin),
        *_build.check_planes(k, "ab", ab, (2, *lanes)),
        _build.check_operand(k, "lit", lit, dtype=torch.int32),
        *rays_p,
        _build.check_operand(k, "nwin", nwin),
        miss_p,
        rays[0].numel(), *(float(x) for x in light_pos),
    )
    return srays, swin, ab, lit, rays, nwin, miss


def accumulate_epilogue(occ: torch.Tensor, ab: torch.Tensor, lit: torch.Tensor,
                        tmp: torch.Tensor, decay_p: torch.Tensor, light_pos,
                        light_intensity: float) -> torch.Tensor:
    """Post-shadow-sweep accumulate: ``tmp`` (3, P, K) += the shadow-masked
    decayed Blinn-Phong term, in place, with ``decay_p`` (P,) the per-packet
    ``0.9**sample``; returns ``tmp``. CPU tensors take
    :func:`accumulate_epilogue_ref`; CUDA tensors launch
    ``rt_accumulate_epilogue``."""
    if occ.device.type == "cpu":
        return accumulate_epilogue_ref(occ, ab, lit, tmp, decay_p, light_pos,
                                       light_intensity)
    k = "accumulate_epilogue"
    lanes = tuple(occ.shape)
    _build.launch(
        k,
        _build.check_operand(k, "occ", occ, lanes, torch.int32),
        *_build.check_planes(k, "ab", ab, (2, *lanes)),
        _build.check_operand(k, "lit", lit, lanes, torch.int32),
        *_build.check_planes(k, "tmp", tmp, (3, *lanes)),
        _build.check_operand(k, "decay_p", decay_p, lanes[:1]),
        occ.numel(), lanes[1], float(light_intensity),
    )
    return tmp
