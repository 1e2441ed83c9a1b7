"""Whitted integrator of the PyTorch port (counterpart of
``raytpu/integrator.py``): the full-width bounce body of ``_trace_sample``
(:611-898, ``bounce_core`` :651), the deferred sky fetch (:575), the
interleaved spp fold of ``render_packets`` (:901-970), tile-major pixel
packets (:1002), ``render_frame`` (:1047) and ``detile`` (:1092).

Per bounce: closest-hit sweep, shade, shadow any-hit sweep, accumulate;
then one sky fetch for the lanes that missed. The sweeps, the raygen and
the sky run through their kernel wrappers (CUDA tensors launch the
hand-written kernels); the shading between sweeps is plain PyTorch, as it
is plain XLA in the JAX body.

Host syncs per frame: the loop condition ``any(active)`` once per bounce
iteration, and the shadow-skip test ``any(lit_candidate)`` once per
iteration where the skip rule applies (``max_bounce_count > 4`` or spp 1).
They are the loop's semantics, as ``lax.while_loop``/``lax.cond`` are in
the JAX body.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from raytpu.config import (
    HIT_EPSILON,
    RAY_TMAX,
    RAY_TMIN,
    SAMPLE_DECAY,
    RenderConfig,
)
from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops import shade
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.raygen import primary_rays_soa, raygen_packed, raygen_packed_ref
from raytpu_torch.ops.sky import sample_cubemap_u32, sample_cubemap_u32_ref
from raytpu_torch.ops.trace import any_hit_wave, closest_hit_wave
from raytpu_torch.ops.traverse import (
    anyhit_sweep,
    anyhit_sweep_ref,
    closest_sweep,
    closest_sweep_ref,
)

__all__ = [
    "RenderStatic", "primary_rays_soa", "render_packets", "render_frame",
    "detile", "tiled_pixels", "plain_kernels",
]

SEG_PACKETS = 64  # packet-count granule of the JAX package (ops/mega.py)

# every traversal tier of the JAX package computes the same hits; the port
# has one walk for all of them
_TRAVERSALS = ("auto", "pallas", "xla", "perlane", "mega", "hybrid")

# the frame's four kernel wrappers, looked up at call time so that
# plain_kernels() can swap in their plain versions
_KERNELS = {"raygen": raygen_packed, "closest": closest_sweep,
            "anyhit": anyhit_sweep, "sky": sample_cubemap_u32}
_PLAIN = {"raygen": raygen_packed_ref, "closest": closest_sweep_ref,
          "anyhit": anyhit_sweep_ref, "sky": sample_cubemap_u32_ref}


@contextlib.contextmanager
def plain_kernels():
    """Within the block, frames run each kernel's plain PyTorch version on
    any device: the reference the kernel path is held against on the card."""
    saved = dict(_KERNELS)
    _KERNELS.update(_PLAIN)
    try:
        yield
    finally:
        _KERNELS.update(saved)


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Render parameters the ported slice implements."""

    width: int
    height: int
    samples_per_pixel: int
    max_bounce_count: int
    skybox_filter: str = "bilinear"
    wavefront: str = "full"
    tile: int = 32
    fold_spp: bool = True

    def __post_init__(self):
        if not self.fold_spp:
            raise ValueError("fold_spp=False (one wave per sample) is not "
                             "ported yet; the port folds spp into the wave")
        if self.skybox_filter != "bilinear":
            raise ValueError(
                f"skybox_filter={self.skybox_filter!r} is not ported yet "
                "(only 'bilinear')")
        if self.wavefront != "full":
            raise ValueError(
                f"wavefront={self.wavefront!r} is not ported yet (only "
                "'full'; the compacted waves come with the fused bounce loop)")

    @classmethod
    def from_config(cls, config: RenderConfig) -> "RenderStatic":
        """The slice's parameters from a ``RenderConfig``. Raises on every
        value the slice does not implement, rather than ignoring it. All
        ``sky_sampler`` values compute the same bilinear function, so each
        maps to the port's one sampler."""
        unsupported = {
            "ray_chunk": (config.ray_chunk, 0),
            "devices": (config.devices, 1),
            "validation": (config.validation, False),
            "divergence": (config.divergence, "off"),
            "bounce_unroll": (config.bounce_unroll, False),
            "chunk_tris": (config.chunk_tris, 0),
            "dtype": (config.dtype, "float32"),
        }
        for name, (got, want) in unsupported.items():
            if got != want:
                raise ValueError(
                    f"RenderConfig.{name}={got!r} is not supported by the "
                    f"PyTorch port (needs {want!r})")
        if config.sky_rebin == "on":
            raise ValueError("RenderConfig.sky_rebin='on' is a rejected TPU "
                             "experiment and is not ported")
        if config.traversal not in _TRAVERSALS:
            raise ValueError(
                f"RenderConfig.traversal={config.traversal!r} is not ported "
                f"(one walk serves {_TRAVERSALS})")
        if config.bvh_builder not in ("auto", "native", "sah"):
            raise ValueError(
                f"RenderConfig.bvh_builder={config.bvh_builder!r} is not "
                "ported yet (the port builds native SAH trees)")
        return cls(
            width=config.width,
            height=config.height,
            samples_per_pixel=config.samples_per_pixel,
            max_bounce_count=config.max_bounce_count,
            skybox_filter=config.skybox_filter,
            wavefront=config.wavefront,
        )


def _count(stats, key, mask):
    """Add the lanes of ``mask`` to ``stats[key]`` on the device (no sync)."""
    if stats is not None:
        n = mask.sum()
        stats[key] = n if key not in stats else stats[key] + n


def _any(mask, stats) -> bool:
    """``mask.any()`` on the host: one device sync, counted in
    ``stats["host_syncs"]``."""
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    return bool(mask.any())


def _bounce_core(ts, rs, o, d, tmp, active, miss_rec, decay, stats):
    """One bounce at full width (``integrator.py:651-736``): closest trace,
    miss record, shadow + Blinn-Phong, mirror/refract continuations."""
    _count(stats, "closest_rays", active)
    lane_tmax = torch.where(active, torch.full_like(o[0], RAY_TMAX),
                            torch.zeros_like(o[0]))
    hit = closest_hit_wave(ts, o, d, RAY_TMIN, lane_tmax, _KERNELS["closest"])
    hit_mask = active & hit.valid
    miss_rec = miss_rec | (active & ~hit.valid)

    pos = v3.add(o, v3.scale(hit.t, d))
    n = hit.n
    is_diffuse = hit_mask & (hit.mat == 0)
    is_mirror = hit_mask & (hit.mat == 1)
    is_refract = hit_mask & (hit.mat == 2)

    # diffuse: backface break (:104-105), shadow ray + Blinn-Phong
    front_face = v3.dot(d, n) < 0.0
    lit_candidate = is_diffuse & front_face
    shadow_o = v3.add(pos, v3.scale(HIT_EPSILON, n))
    to_light = tuple(ts.light_pos[c] - pos[c] for c in range(3))
    light_dist = v3.norm(to_light)
    l = v3.scale(1.0 / torch.clamp_min(light_dist, 1e-30), to_light)

    # shadow-skip rule (:712-720): shallow multi-sample loops always sweep
    if (rs.max_bounce_count <= 4 and rs.samples_per_pixel > 1) or _any(
            lit_candidate, stats):
        _count(stats, "shadow_rays", lit_candidate)
        occluded = any_hit_wave(
            ts, shadow_o, l, RAY_TMIN,
            torch.where(lit_candidate, light_dist, torch.zeros_like(light_dist)),
            _KERNELS["anyhit"],
        )
    else:
        occluded = torch.zeros_like(lit_candidate)
    phong = shade.blinn_phong_soa(n, l, v3.neg(d), ts.light_intensity)
    shade_mask = lit_candidate & ~occluded
    zero = torch.zeros_like(o[0])
    tmp = v3.add(tmp, v3.where(shade_mask, v3.scale(decay, phong),
                               (zero, zero, zero)))

    # mirror / refract continuations (:132-177)
    o_m, d_m = shade.mirror_bounce_soa(d, n, pos)
    o_r, d_r = shade.refract_bounce_soa(d, n, pos)
    cont = is_mirror | is_refract
    o = v3.where(cont, v3.where(is_mirror, o_m, o_r), o)
    d = v3.where(cont, v3.where(is_mirror, d_m, d_r), d)
    return o, d, tmp, cont, miss_rec


def _deferred_sky(ts, missed, d, tmp):
    """Once-per-wave sky fetch for the miss lanes (``integrator.py:575``):
    z-flipped lookup, non-miss lanes pointed at (0, 0, 1) and masked."""
    zero = torch.zeros_like(d[0])
    dirs = (torch.where(missed, d[0], zero), torch.where(missed, d[1], zero),
            torch.where(missed, -d[2], zero + 1.0))
    h, w = ts.sky_hw
    sky = _KERNELS["sky"](ts.skybox_u32, h, w, dirs)
    return v3.where(missed, sky, tmp)


def _trace_sample(ts: TorchScene, rs: RenderStatic, o, d,
                  sample_idx: torch.Tensor, active0: torch.Tensor,
                  stats: Optional[dict] = None):
    """One sample wave through the bounce loop -> Vec3 color of (P, K)."""
    p, k = o[0].shape
    tmp = tuple(torch.full((p, k), c, dtype=torch.float32, device=o[0].device)
                for c in shade.ambient_tuple())
    decay = torch.pow(SAMPLE_DECAY, sample_idx.to(torch.float32)).expand(p, k)
    miss_rec = torch.zeros((p, k), dtype=torch.bool, device=o[0].device)
    active = active0
    j = 0
    # inclusive bounce cap (shader.rgen:84); exits once every lane is done
    while j <= rs.max_bounce_count and _any(active, stats):
        o, d, tmp, active, miss_rec = _bounce_core(
            ts, rs, o, d, tmp, active, miss_rec, decay, stats)
        j += 1
    # at loop exit d is each miss lane's miss direction (no carry needed)
    return _deferred_sky(ts, miss_rec, d, tmp)


def render_packets(ts: TorchScene, rs: RenderStatic, camera: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor, active0: torch.Tensor,
                   rays6: Optional[torch.Tensor] = None,
                   stats: Optional[dict] = None):
    """Render packets of pixels ``px``/``py`` (P, K) -> Vec3 color (P, K),
    sample-averaged. All spp sample waves are folded into the packet axis,
    interleaved (packet t*spp + s = tile t, sample s).

    ``rays6`` replaces the raygen: the packed (6, spp*P, K) primary rays of
    the folded wave. ``stats``, if a dict, receives device counters of the
    rays traced (``closest_rays``, ``shadow_rays``) and the host count
    ``host_syncs``."""
    p, k = px.shape
    spp = rs.samples_per_pixel
    pxs = px.repeat_interleave(spp, dim=0)
    pys = py.repeat_interleave(spp, dim=0)
    act = active0.repeat_interleave(spp, dim=0)
    s_row = torch.arange(spp, dtype=torch.float32, device=px.device).repeat(p)
    if rays6 is None:
        rays6 = _KERNELS["raygen"](camera, s_row, pxs, pys, spp, rs.width,
                                   rs.height)
    o = (rays6[0], rays6[1], rays6[2])
    d = (rays6[3], rays6[4], rays6[5])
    colors = _trace_sample(ts, rs, o, d, s_row[:, None], act, stats)
    return tuple(c.reshape(p, spp, k).mean(dim=1) for c in colors)


def tiled_pixels(rs: RenderStatic, device):
    """Tile-major pixel packets (``integrator._tiled_pixels`` :1002):
    ``(px, py)`` (P, K) f32 and the in-frame lane mask, the packet count
    padded to a ``SEG_PACKETS`` multiple with dead packets."""
    t = rs.tile
    w_t = -(-rs.width // t)
    h_t = -(-rs.height // t)
    ty, tx = torch.meshgrid(torch.arange(h_t, device=device),
                            torch.arange(w_t, device=device), indexing="ij")
    iy, ix = torch.meshgrid(torch.arange(t, device=device),
                            torch.arange(t, device=device), indexing="ij")
    xs = tx.reshape(-1, 1) * t + ix.reshape(1, -1)
    ys = ty.reshape(-1, 1) * t + iy.reshape(1, -1)
    in_frame = (xs < rs.width) & (ys < rs.height)
    px = torch.clamp_max(xs, rs.width - 1).to(torch.float32)
    py = torch.clamp_max(ys, rs.height - 1).to(torch.float32)
    pad = (-px.shape[0]) % SEG_PACKETS
    if pad:
        zf = torch.zeros((pad, px.shape[1]), dtype=torch.float32, device=device)
        px = torch.cat([px, zf])
        py = torch.cat([py, zf])
        in_frame = torch.cat([in_frame, zf.bool()])
    return (px, py), in_frame


def detile(colors, rs: RenderStatic) -> torch.Tensor:
    """Packets -> (H, W, 3) image by reshape/permute (padding dropped)."""
    t = rs.tile
    h_t = -(-rs.height // t)
    w_t = -(-rs.width // t)
    planes = [
        c[: h_t * w_t]
        .reshape(h_t, w_t, t, t)
        .permute(0, 2, 1, 3)
        .reshape(h_t * t, w_t * t)[: rs.height, : rs.width]
        for c in colors
    ]
    return torch.stack(planes, dim=-1)


def render_frame(ts: TorchScene, rs: RenderStatic, camera: torch.Tensor,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """Full frame -> (H, W, 3) f32 image on the scene's device."""
    (px, py), in_frame = tiled_pixels(rs, ts.device)
    colors = render_packets(ts, rs, camera, px, py, in_frame, stats=stats)
    return detile(colors, rs)
