"""Material shading math (counterpart of ``raytpu/ops/shade.py:53-101``):
Blinn-Phong for diffuse, mirror reflection, refraction with Snell and TIR.
Mask-free; the integrator selects per lane.
"""

from __future__ import annotations

import torch

from raytpu_torch.config import (
    AMBIENT_COEFF,
    AMBIENT_INTENSITY,
    DIFFUSE_COEFF,
    HIT_EPSILON,
    INDEX_OF_REFRACTION,
    SPECULAR_COEFF,
    SPECULAR_EXPONENT,
)
from raytpu_torch.ops import vec3 as v3


def ambient_tuple():
    """Initial per-sample color ``Iamb * ka`` (``src/shader.rgen:81``)."""
    return tuple(
        float(a) * float(k) for a, k in zip(AMBIENT_INTENSITY, AMBIENT_COEFF)
    )


def reflect_soa(d, n):
    """``d - 2 (d.n) n`` componentwise."""
    k = 2.0 * v3.dot(d, n)
    return v3.sub(d, v3.scale(k, n))


def blinn_phong_soa(n, l, view, light_intensity):
    """Componentwise Blinn-Phong (``src/shader.rgen:116-126``); the caller
    applies the decay and the shadow mask."""
    h = v3.normalize(v3.add(l, view))
    ndotl = torch.clamp_min(v3.dot(n, l), 0.0)
    ndoth = torch.clamp_min(v3.dot(n, h), 0.0)
    spec = ndoth ** SPECULAR_EXPONENT
    return tuple(
        light_intensity * (kd_c * ndotl + ks_c * spec)
        for kd_c, ks_c in zip(DIFFUSE_COEFF, SPECULAR_COEFF)
    )


def mirror_bounce_soa(d, n, hit_pos):
    """Mirror branch (``src/shader.rgen:132-138``)."""
    new_o = v3.add(hit_pos, v3.scale(HIT_EPSILON, n))
    return new_o, reflect_soa(d, n)


def refract_bounce_soa(d, n, hit_pos):
    """Refractive branch with Snell + TIR (``src/shader.rgen:139-177``)."""
    ndoti = v3.dot(d, n)
    outwards = ndoti > 0.0
    n_f = v3.where(outwards, v3.neg(n), n)
    ndoti_f = torch.where(outwards, -ndoti, ndoti)
    ratio = torch.where(
        outwards,
        torch.full_like(ndoti, INDEX_OF_REFRACTION),
        torch.full_like(ndoti, 1.0 / INDEX_OF_REFRACTION),
    )
    k = 1.0 - ratio * ratio * (1.0 - ndoti_f * ndoti_f)
    tir = k < 0.0

    d_tir = reflect_soa(d, n_f)
    o_tir = v3.add(hit_pos, v3.scale(HIT_EPSILON, n_f))

    coeff = ratio * ndoti_f + torch.sqrt(torch.clamp_min(k, 0.0))
    r = v3.normalize(v3.sub(v3.scale(ratio, d), v3.scale(coeff, n_f)))
    o_ref = v3.sub(hit_pos, v3.scale(HIT_EPSILON, n_f))

    return v3.where(tir, o_tir, o_ref), v3.where(tir, d_tir, r)
