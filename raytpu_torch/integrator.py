"""Whitted integrator of the PyTorch port (counterpart of
``raytpu/integrator.py``): the fused bounce loop on the packed ABI,
``_trace_sample_fused`` (:379-572) with its sort-once compacted waves
(``_wave_budget`` :239, ``_wave_rungs`` :258), the XLA bounce body of
``_trace_sample`` (:611-898, ``bounce_core`` :651) with its per-iteration
resort (``body_compact`` :748) for the per-(instance, mesh) loop, the
deferred sky fetch (:575) with its three filters, the validation guards
(:567-571, :857-862), ``render_packets`` (:901-970) with its interleaved
spp fold and its unfolded loop of one wave per sample, ``render_pixels``
(:976) for a list of pixels, tile-major pixel packets (:1002),
``render_frame`` (:1047) with its ray chunks, and ``detile`` (:1092).
``parallel/dist.py`` shards a frame's tile rows over several devices, each
slot through ``render_packets``.

Each packed tier has one loop, the fused loop (``wavefront="compact"`` by
default): per bounce a closest-hit sweep, the fused shade pass, a shadow
any-hit sweep and the fused accumulate pass, on the packed (6, P, K) rays
and (3, P, K) radiance; after the first bounce the packets sort live-first
once and later bounces run over waves of the live prefix only. Every one
of these, the raygen and the sky run through their kernel wrappers (CUDA
tensors launch the hand-written kernels); ``make_trace_state``, the sort
and the bookkeeping are plain PyTorch, as they are plain XLA in the JAX
loop.

The sweeps follow the scene's traversal tier as the JAX package routes
them (``raytpu/ops/trace.py:491-547``, ``_use_perlane`` :550, ``_use_mega``
:580): the per-lane sweeps (K7 prepass, K1, K2; ``ops/perlane.py``) under
"perlane", under "auto" where the scene resolved to it, and on the first
bounce under "hybrid"; the consensus sweeps (K7 prepass, K8, K9;
``ops/consensus.py``) under "mega", under "auto" resolved to "mega", and
on the later bounces under "hybrid"; the chained sweeps (K10a, K10b;
``ops/traverse.py``) under "pallas". A wave that is not whole blocks of
``BLOCK_PACKETS`` takes the chained sweeps, as in the JAX package.

"xla" is no packed tier (``_use_perlane``, ``_use_mega`` and
``_all_pallas`` all reject it), so the JAX package's ``_use_fused``
(:204-236) never takes the fused loop for it: an "xla" frame renders
through the XLA body, and every sweep of it is the unpacked
per-(instance, mesh) loop (``ops/trace.closest_hit_loop`` /
``any_hit_loop``) on the one-mesh walks K11a/K11b. The packed tiers reject
packets other than ``PACKET_K`` lanes too (tiles other than 32x32), so
such frames render so on every traversal value (``_tier``). A scene with
no BVH (``traversal="brute"`` or ``bvh_builder="brute"``) renders through
the XLA body too, every sweep the same loop over the brute tracers
(``brute_closest_kernel`` / ``brute_anyhit_kernel``). Those two tiers are
the only ones the XLA body serves.

Host syncs per frame (each counted in ``stats["host_syncs"]``): the loop
condition once per bounce iteration (``any(window > 0)`` at full width,
the live prefix length ``n_eff`` on the fused compacted path, the live
packet count ``n_live`` in the body's compacted iterations), and the
shadow-skip test ``any(lit)`` once per wave where the skip rule applies
(``max_bounce_count > 4`` or spp 1). They are the loop's semantics, as
``lax.while_loop``/``lax.cond`` are in the JAX loop. On one card
``Renderer`` replays the fused loop's stretches between two reads as CUDA
graphs (``graphs.py``), with the same reads.

Under a profiler the phases are ``rt.*`` spans (``utils/spans.py``): per
wave ``rt.raygen``, ``rt.loop`` (the bounce loop, with ``rt.bounce``,
``rt.sweep.*``, ``rt.shade``, ``rt.accumulate``, ``rt.sort``, each
``rt.sync`` and ``rt.later`` around each unit past the first bounce) and
``rt.sky``, then ``rt.detile``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch

from raytpu_torch import _build
from raytpu_torch.accel import BVH_BUILDERS
from raytpu_torch.config import (
    HIT_EPSILON,
    RAY_TMAX,
    RAY_TMIN,
    SAMPLE_DECAY,
    RenderConfig,
)
from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops import shade
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.consensus import (
    mega_anyhit_sweep,
    mega_anyhit_sweep_ref,
    mega_closest_sweep,
    mega_closest_sweep_ref,
)
from raytpu_torch.ops.epilogue import (
    BP,
    accumulate_epilogue,
    accumulate_epilogue_ref,
    shade_epilogue,
    shade_epilogue_ref,
)
from raytpu_torch.ops.intersect import (
    brute_anyhit,
    brute_anyhit_ref,
    brute_closest,
    brute_closest_ref,
)
from raytpu_torch.ops.mega import BLOCK_PACKETS
from raytpu_torch.ops.perlane import (
    perlane_anyhit_sweep,
    perlane_anyhit_sweep_ref,
    perlane_closest_sweep,
    perlane_closest_sweep_ref,
)
from raytpu_torch.ops.raygen import primary_rays_soa, raygen_packed, raygen_packed_ref
from raytpu_torch.ops.sky import (
    sample_cubemap_u32,
    sample_cubemap_u32_nearest,
    sample_cubemap_u32_nearest_ref,
    sample_cubemap_u32_ref,
)
from raytpu_torch.ops.trace import (
    any_hit_loop,
    brute_mesh_anyhit,
    brute_mesh_closest,
    closest_hit_loop,
)
from raytpu_torch.ops.traverse import (
    anyhit_sweep,
    anyhit_sweep_ref,
    closest_sweep,
    closest_sweep_ref,
    make_trace_state,
    mesh_anyhit,
    mesh_anyhit_ref,
    mesh_closest,
    mesh_closest_ref,
)
from raytpu_torch.utils import validation
from raytpu_torch.utils.spans import span, spanned

__all__ = [
    "RenderStatic", "primary_rays_soa", "render_packets", "render_pixels",
    "render_frame", "detile", "tiled_pixels", "kernels", "plain_kernels",
]

SEG_PACKETS = 64  # packet-count granule of the JAX package (ops/mega.py)
# lanes of a packet of the packed tiers and the fused loop: one 32x32 tile
# (raytpu/ops/traverse_pallas.py PACKET_K); other tiles take the XLA body
PACKET_K = 1024

# every traversal tier of the JAX package computes the same hits; the port
# walks them with the per-lane, the consensus or the chained sweeps, or the
# per-(instance, mesh) loop on the one-mesh walks or the brute tracers
# (_tier); "brute" leaves the scene without a BVH (render.Renderer)
_TRAVERSALS = ("auto", "pallas", "xla", "perlane", "mega", "hybrid", "brute")

# the frame's kernel wrappers, looked up at call time so that
# plain_kernels() can swap in their plain versions
_KERNELS = {"raygen": raygen_packed, "closest": closest_sweep,
            "anyhit": anyhit_sweep, "perlane_closest": perlane_closest_sweep,
            "perlane_anyhit": perlane_anyhit_sweep,
            "mega_closest": mega_closest_sweep,
            "mega_anyhit": mega_anyhit_sweep, "mesh_closest": mesh_closest,
            "mesh_anyhit": mesh_anyhit, "brute_closest": brute_closest,
            "brute_anyhit": brute_anyhit, "sky": sample_cubemap_u32,
            "sky_nearest": sample_cubemap_u32_nearest,
            "shade": shade_epilogue, "accumulate": accumulate_epilogue}
_DEFAULT_KERNELS = dict(_KERNELS)
_PLAIN = {"raygen": raygen_packed_ref, "closest": closest_sweep_ref,
          "anyhit": anyhit_sweep_ref,
          "perlane_closest": perlane_closest_sweep_ref,
          "perlane_anyhit": perlane_anyhit_sweep_ref,
          "mega_closest": mega_closest_sweep_ref,
          "mega_anyhit": mega_anyhit_sweep_ref,
          "mesh_closest": mesh_closest_ref, "mesh_anyhit": mesh_anyhit_ref,
          "brute_closest": brute_closest_ref, "brute_anyhit": brute_anyhit_ref,
          "sky": sample_cubemap_u32_ref,
          "sky_nearest": sample_cubemap_u32_nearest_ref,
          "shade": shade_epilogue_ref, "accumulate": accumulate_epilogue_ref}


@contextlib.contextmanager
def kernels(**fns):
    """Within the block, frames call ``fns`` in place of the kernel
    wrappers of those names (``raygen``, ``closest``, ``anyhit``,
    ``perlane_closest``, ``perlane_anyhit``, ``mega_closest``,
    ``mega_anyhit``, ``mesh_closest``, ``mesh_anyhit``, ``brute_closest``,
    ``brute_anyhit``, ``sky``, ``sky_nearest``, ``shade``, ``accumulate``),
    with the wrappers' arguments."""
    unknown = set(fns) - set(_KERNELS)
    if unknown:
        raise KeyError(f"no kernel wrapper named {sorted(unknown)}")
    saved = dict(_KERNELS)
    _KERNELS.update(fns)
    try:
        yield
    finally:
        _KERNELS.update(saved)


def plain_kernels():
    """Within the block, frames run each kernel's plain PyTorch version on
    any device: the reference the kernel path is held against on the card."""
    return kernels(**_PLAIN)


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Render parameters of the port (``raytpu/integrator.py:97-202``).

    ``wavefront``: "compact" compacts the bounces after the first, in the
    fused loop by one live-first sort, in the XLA body by a resort every
    iteration (``body_compact``); "full" runs every bounce at full width.
    ``ladder``: "auto" moves the fused compacted loop to smaller waves as
    the live prefix shrinks (``_wave_rungs``), "off" keeps the one budget.
    ``shadow_order``: the per-lane and consensus shadow sweeps' entry order
    (``raytpu/integrator.py:129``), "light" (nearest the light first) or
    "origin" (by entry depth).

    ``skybox_filter``: "bilinear" (K6), "nearest" (one tap, K6's single-tap
    mode) or "bilinear2x" (one tap into the scene's 2x prefiltered map,
    ``TorchScene.skybox_u32_2x``). ``fold_spp``: True traces every sample
    in one wave (``render_packets``), False one wave per sample.
    ``ray_chunk``: rays per chunk of the frame (whole packets, rounded up
    to ``SEG_PACKETS``; 0 traces the whole frame at once). ``validation``:
    the non-finite guards at the end of both bounce loops
    (``utils/validation.guard``)."""

    width: int
    height: int
    samples_per_pixel: int
    max_bounce_count: int
    skybox_filter: str = "bilinear"
    wavefront: str = "compact"
    ladder: str = "auto"
    tile: int = 32
    fold_spp: bool = True
    shadow_order: str = "light"
    ray_chunk: int = 0
    validation: bool = False

    @property
    def packet_size(self) -> int:
        return self.tile * self.tile

    def __post_init__(self):
        for name, allowed in (("skybox_filter", ("bilinear", "nearest",
                                                  "bilinear2x")),
                              ("wavefront", ("full", "compact")),
                              ("ladder", ("auto", "off")),
                              ("shadow_order", ("light", "origin"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: use one "
                                 f"of {allowed}")
        if self.ray_chunk < 0:
            raise ValueError(f"ray_chunk={self.ray_chunk}: use 0 (the whole "
                             "frame) or a positive ray count")

    @classmethod
    def from_config(cls, config: RenderConfig) -> "RenderStatic":
        """The render parameters of a ``RenderConfig``. Raises on a value
        the JAX package does not know, rather than ignoring it. Every
        ``bvh_builder`` of the JAX package is accepted (``accel.attach_bvh``
        builds its tree, "brute" none), and so is ``chunk_tris`` >= 0 (the
        chunks ``attach_bvh`` cuts). ``devices`` is the Renderer's
        (``devices > 1`` shards the frame, ``parallel/``); it must be at
        least 1."""
        if config.devices < 1:
            raise ValueError(f"RenderConfig.devices={config.devices!r}: use 1 "
                             "device or more")
        if config.chunk_tris < 0:
            raise ValueError(f"RenderConfig.chunk_tris={config.chunk_tris!r}: "
                             "use 0 (one tree a mesh) or a triangle count")
        _check_traversal(config.traversal)
        if config.bvh_builder not in BVH_BUILDERS + ("brute",):
            raise ValueError(
                f"RenderConfig.bvh_builder={config.bvh_builder!r}: use one of "
                f"{BVH_BUILDERS + ('brute',)}")
        return cls(
            width=config.width,
            height=config.height,
            samples_per_pixel=config.samples_per_pixel,
            max_bounce_count=config.max_bounce_count,
            skybox_filter=config.skybox_filter,
            wavefront=config.wavefront,
            ray_chunk=config.ray_chunk,
            validation=config.validation,
        )


def _check_traversal(traversal: str) -> None:
    if traversal not in _TRAVERSALS:
        raise ValueError(f"traversal={traversal!r} is not ported (the "
                         f"sweeps serve {_TRAVERSALS})")


def _tier(ts: TorchScene, p: int, primary: bool, k: int) -> str:
    """The sweeps a wave of ``p`` packets of ``k`` lanes takes
    (``raytpu/ops/trace.py:550`` ``_use_perlane``, :580 ``_use_mega`` and
    :600 ``_all_pallas``, without their TPU test): "brute" (the
    per-(instance, mesh) loop over the brute tracers) for a scene with no
    BVH, whatever its traversal value, as every test there needs
    ``has_bvh``; "xla" (the per-(instance, mesh) loop) under "xla" and
    "brute" (a scene that has a BVH walks it, :290), and on every traversal
    value for packets other than ``PACKET_K`` lanes; "perlane" under "perlane",
    under "auto" where the scene resolved to it, and under "hybrid" on the
    ``primary`` (first-bounce) sweeps; "mega" under "mega", under "auto"
    resolved to "mega" and under "hybrid" on the later ones; "pallas" (the
    chained sweeps) under "pallas", and for any wave that is not whole
    blocks of ``BLOCK_PACKETS``.

    At ``k != PACKET_K`` the JAX package's three packed tiers all refuse
    the wave, so its per-(instance, mesh) loop takes it, and per mesh
    ``_use_pallas`` (:619) picks the one-mesh Pallas kernel under "pallas"
    and the XLA packet walk (``ops/packet.py``) under every other value.
    Both compute one mesh's closest hit and occlusion, which K11a/K11b
    compute in the port, so every value takes the loop on them."""
    _check_traversal(ts.traversal)
    if not ts.has_bvh:
        return "brute"
    if ts.traversal in ("xla", "brute") or k != PACKET_K:
        return "xla"
    if p % BLOCK_PACKETS:
        return "pallas"
    if (ts.traversal == "perlane"
            or (ts.traversal == "auto" and ts.auto_tier == "perlane")
            or (ts.traversal == "hybrid" and primary)):
        return "perlane"
    if ts.traversal in ("auto", "mega", "hybrid"):
        return "mega"
    return "pallas"


def frame_tier(ts: TorchScene, p: int, k: int) -> str:
    """The sweeps a frame of ``p`` packets of ``k`` lanes takes:
    "perlane", "mega", "pallas" (the chained sweeps), "xla" (the
    per-(instance, mesh) loop) or "brute" (that loop over the brute
    tracers) on every bounce, or "hybrid" (per-lane on the first bounce,
    consensus on the later ones)."""
    first, later = _tier(ts, p, True, k), _tier(ts, p, False, k)
    return first if first == later else "hybrid"


def _sweeps(ts: TorchScene, rs, p: int, k: int, primary: bool):
    """``(closest, anyhit)`` packed sweep functions for a wave of ``p``
    packets of ``k`` lanes, with the same arguments whichever the packed
    tier."""
    tier = _tier(ts, p, primary, k)
    if tier == "pallas":
        return _KERNELS["closest"], _KERNELS["anyhit"]
    return (_KERNELS[f"{tier}_closest"],
            functools.partial(_KERNELS[f"{tier}_anyhit"],
                              order=rs.shadow_order))


def _traces(ts: TorchScene):
    """``(closest, occlusion)`` of a wave for the XLA body, each with
    ``closest_hit_loop``'s / ``any_hit_loop``'s arguments: the
    per-(instance, mesh) loop over the brute tracers for a scene with no
    BVH (tier "brute"), else on K11a/K11b (tier "xla"; :func:`_tier`)."""
    if not ts.has_bvh:
        return (functools.partial(closest_hit_loop, walk=functools.partial(
                    brute_mesh_closest, closest=_KERNELS["brute_closest"])),
                functools.partial(any_hit_loop, walk=functools.partial(
                    brute_mesh_anyhit, anyhit=_KERNELS["brute_anyhit"])))
    return (functools.partial(closest_hit_loop, walk=_KERNELS["mesh_closest"]),
            functools.partial(any_hit_loop, walk=_KERNELS["mesh_anyhit"]))


def _use_fused(ts: TorchScene, p: int, k: int) -> bool:
    """Whether the fused loop renders a frame of ``p`` packets of ``k``
    lanes (``integrator._use_fused`` :204, without its TPU test): the first
    bounce's tier is a packed one, which "xla" and "brute" are not, nor any
    tier at packets other than ``PACKET_K`` lanes (:234). Every other frame
    renders through the XLA body."""
    return _tier(ts, p, True, k) not in ("xla", "brute")


def _count(stats, key, mask):
    """Add the lanes of ``mask`` to ``stats[key]`` on the device (no sync)."""
    if stats is not None:
        n = mask.sum()
        stats[key] = n if key not in stats else stats[key] + n


@spanned("rt.sync")
def _read(x: torch.Tensor, stats):
    """The value of the one-element ``x`` on the host: one device sync,
    counted in ``stats["host_syncs"]``."""
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    return x.item()


def _any(mask, stats) -> bool:
    """``mask.any()`` on the host (one counted sync)."""
    return bool(_read(mask.any(), stats))


def _shadow_always(rs) -> bool:
    """The shadow-skip rule (``integrator.py:699-720``): shallow
    multi-sample loops always sweep; others skip the sweep when no lane is
    a lit candidate, which costs a sync."""
    return rs.max_bounce_count <= 4 and rs.samples_per_pixel > 1


@spanned("rt.bounce")
def _bounce_core(ts, rs, o, d, tmp, active, miss_rec, decay, stats, traces):
    """One bounce at the width of its inputs (``integrator.py:651-736``)
    through the ``traces`` (:func:`_traces`): closest trace, miss record,
    shadow + Blinn-Phong, mirror/refract continuations. Per-lane results
    depend only on the lane, so it runs alike over the full wave or a
    compacted wave of it."""
    _count(stats, "closest_rays", active)
    lane_tmax = torch.where(active, torch.full_like(o[0], RAY_TMAX),
                            torch.zeros_like(o[0]))
    with span("rt.sweep.closest"):
        hit = traces[0](ts, o, d, RAY_TMIN, lane_tmax)
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

    if _shadow_always(rs) or _any(lit_candidate, stats):
        _count(stats, "shadow_rays", lit_candidate)
        with span("rt.sweep.shadow"):
            occluded = traces[1](
                ts, shadow_o, l, RAY_TMIN,
                torch.where(lit_candidate, light_dist, torch.zeros_like(light_dist)))
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


@spanned("rt.sky")
def _deferred_sky(ts, rs, missed, d, tmp, stats):
    """Once-per-wave sky fetch for the miss lanes (``integrator.py:575-607``):
    z-flipped lookup, non-miss lanes pointed at (0, 0, 1) and masked, by
    ``rs.skybox_filter``: "bilinear" through K6, "nearest" through K6's
    single tap, "bilinear2x" through the single tap on the 2x map. With
    ``rs.validation``, the radiance and the final directions pass the
    guard first (:567-571, :857-862)."""
    if rs.validation:
        validation.guard(tmp, "bounce-loop radiance", stats)
        validation.guard(d, "final ray directions", stats)
    zero = torch.zeros_like(d[0])
    dirs = (torch.where(missed, d[0], zero), torch.where(missed, d[1], zero),
            torch.where(missed, -d[2], zero + 1.0))
    h, w = ts.sky_hw
    if rs.skybox_filter == "bilinear":
        sky = _KERNELS["sky"](ts.skybox_u32, h, w, dirs)
    elif rs.skybox_filter == "nearest":
        sky = _KERNELS["sky_nearest"](ts.skybox_u32, h, w, dirs)
    else:   # "bilinear2x": one tap into the 2x-prefiltered map
        if ts.skybox_u32_2x is None:
            raise ValueError(
                "skybox_filter='bilinear2x' needs the scene's 2x sky, which "
                "build_device_scene makes for a config with that filter")
        sky = _KERNELS["sky_nearest"](ts.skybox_u32_2x, 2 * h, 2 * w, dirs)
    return v3.where(missed, sky, tmp)


def _trace_sample(ts: TorchScene, rs: RenderStatic, o, d,
                  sample_idx: torch.Tensor, active0: torch.Tensor,
                  stats: Optional[dict] = None):
    """One sample wave through the XLA body's bounce loop -> ``(missed, d,
    radiance)`` of (P, K) for the sky (:func:`_deferred_sky`).

    With ``wavefront="compact"`` and a budget (P >= 128), ``body_compact``
    (``integrator.py:748-836``): j=0 is peeled and runs full width; every
    later iteration sorts the packets live-first (a stable argsort), runs
    ``_bounce_core`` over disjoint waves of ``budget`` rows that cover the
    live packets, and restores frame order with the inverse permutation.
    The budget divides P, so the waves never overlap, and the frame equals
    the full-width body's bit for bit but for exact ties. The live packet
    count is the iteration's one host read; it is also the loop condition
    (no live packet, no live lane)."""
    p, k = o[0].shape
    tmp = tuple(torch.full((p, k), c, dtype=torch.float32, device=o[0].device)
                for c in shade.ambient_tuple())
    decay = torch.pow(SAMPLE_DECAY, sample_idx.to(torch.float32)).expand(p, k)
    miss_rec = torch.zeros((p, k), dtype=torch.bool, device=o[0].device)
    active = active0
    budget = _wave_budget(p) if rs.wavefront == "compact" else 0
    traces = _traces(ts)
    j = 0
    if not budget:
        # inclusive bounce cap (shader.rgen:84); exits once every lane is done
        while j <= rs.max_bounce_count and _any(active, stats):
            o, d, tmp, active, miss_rec = _bounce_core(
                ts, rs, o, d, tmp, active, miss_rec, decay, stats, traces)
            j += 1
    else:
        o, d, tmp, active, miss_rec = _bounce_core(      # the peeled j = 0
            ts, rs, o, d, tmp, active, miss_rec, decay, stats, traces)
        j = 1
        while j <= rs.max_bounce_count:
            live = active.any(dim=1)
            n_live = int(_read(live.sum(), stats))
            if not n_live:
                break
            with span("rt.sort"):
                order = torch.argsort((~live).to(torch.int32), stable=True)
                inv = torch.argsort(order, stable=True)
                planes = [x.index_select(0, order)
                          for x in (*o, *d, *tmp, active, miss_rec, decay)]
            for s in range(0, n_live, budget):
                w = [x[s:s + budget] for x in planes]
                out = _bounce_core(ts, rs, tuple(w[0:3]), tuple(w[3:6]),
                                   tuple(w[6:9]), w[9], w[10], w[11], stats,
                                   traces)
                for x, y in zip(planes, (*out[0], *out[1], *out[2], out[3],
                                         out[4])):
                    x[s:s + budget] = y
            with span("rt.sort"):
                o, d, tmp = (tuple(planes[i + c].index_select(0, inv)
                                   for c in range(3)) for i in (0, 3, 6))
                active, miss_rec = (planes[i].index_select(0, inv)
                                    for i in (9, 10))
            j += 1
    # at loop exit d is each miss lane's miss direction (no carry needed)
    return miss_rec, d, tmp


def _seg_divisor(p: int, cap: int) -> int:
    """The largest divisor of ``p`` that is a ``SEG_PACKETS`` multiple and
    at most ``cap`` (0 if none)."""
    return max((b for b in range(SEG_PACKETS, cap + 1, SEG_PACKETS)
                if p % b == 0), default=0)


def _wave_budget(p: int) -> int:
    """Compacted-wave row budget (``integrator._wave_budget`` :239): the
    largest divisor of P that is a ``SEG_PACKETS`` multiple and at most
    about P/4, so that waves tile P exactly; 0 (no compaction) when no
    divisor gives a real subset, i.e. P < 2 * SEG_PACKETS."""
    best = _seg_divisor(p, max(p // 4, SEG_PACKETS))
    return best if best * 2 <= p else 0


def _wave_rungs(p: int, budget: int, max_rungs: int = 3) -> list:
    """Descending wave-budget ladder (``integrator._wave_rungs`` :258):
    ``budget``, then each next rung the largest divisor of P that is a
    ``SEG_PACKETS`` multiple and at most a quarter of the one before. Live
    packets stay a prefix of the sorted wave, so once the prefix fits a
    smaller rung it fits it for good."""
    rungs = [budget]
    while len(rungs) < max_rungs:
        nxt = _seg_divisor(p, rungs[-1] // 4)
        if not nxt:
            break
        rungs.append(nxt)
    return rungs


def _loop_budget(p: int, rs) -> int:
    """The fused loop's compacted-wave budget for a wave of ``p`` packets
    (0: every bounce at full width): ``_wave_budget`` under
    ``wavefront="compact"``, where it tiles P in whole ``BP`` steps."""
    budget = _wave_budget(p) if rs.wavefront == "compact" else 0
    if budget and (p % budget != 0 or budget % BP != 0):
        return 0
    return budget


def _loop_rungs(p: int, budget: int, rs) -> list:
    """The wave ladder the fused loop walks down (``rs.ladder``)."""
    return _wave_rungs(p, budget) if rs.ladder == "auto" else [budget]


def _shade_wave(ts, rs, rays, win, miss, stats, primary):
    """The first half of a fused bounce over a wave: the closest sweep by
    tier (:func:`_sweeps`; ``primary`` for the first bounce) and the shade
    pass, which writes the continuation rays over ``rays`` and the miss
    flags over ``miss`` -> the shade pass's outputs."""
    closest, _ = _sweeps(ts, rs, rays.shape[1], rays.shape[2], primary)
    _count(stats, "closest_rays", win > 0.0)
    with span("rt.sweep.closest"):
        st = closest(ts, rays, RAY_TMIN, make_trace_state(win))
    with span("rt.shade"):
        return _KERNELS["shade"](rays, st, miss, ts.light[:3], ts.light[3])


def _light_wave(ts, rs, shaded, win, tmp, decay_p, stats, primary,
                shadow: bool):
    """The second half of a fused bounce over a wave, on the shade pass's
    outputs ``shaded``: the shadow sweep where ``shadow``, the accumulate
    pass into ``tmp`` and the next windows into ``win``."""
    srays, swin, ab, lit, _, nwin, _ = shaded
    occ = torch.zeros_like(lit)
    if shadow:
        _, anyhit = _sweeps(ts, rs, srays.shape[1], srays.shape[2], primary)
        _count(stats, "shadow_rays", lit != 0)
        with span("rt.sweep.shadow"):
            anyhit(ts, srays, RAY_TMIN, swin, occ)
    with span("rt.accumulate"):
        _KERNELS["accumulate"](occ, ab, lit, tmp, decay_p, ts.light[:3],
                               ts.light[3])
    win.copy_(nwin)


@spanned("rt.bounce")
def _fused_step(ts, rs, rays, win, tmp, miss, decay_p, stats, primary):
    """One fused bounce over a wave (``_trace_sample_fused.step`` :448):
    closest sweep, shade pass, shadow sweep (or its skip, :463-472: where
    the skip rule applies, one host read of ``any(lit)``), accumulate
    pass. ``rays``, ``tmp`` and ``miss`` are updated in place, ``win`` too:
    the arguments may be waves ``x[:, s:s+b]`` of the loop's buffers."""
    shaded = _shade_wave(ts, rs, rays, win, miss, stats, primary)
    shadow = _shadow_always(rs) or _any(shaded[3] != 0, stats)
    _light_wave(ts, rs, shaded, win, tmp, decay_p, stats, primary, shadow)


def loop_ops(p: int, rs):
    """The fused loop's schedule on a wave of ``p`` packets: a generator of
    its units and host reads in order, to which :func:`drive` sends each
    read's value. The units (:class:`_FusedLoop` runs them):

    * ``("begin",)``: the loop's buffers; ``("end",)``: the result, back in
      frame order;
    * ``("step", s, b, primary)``: a bounce over packets ``[s, s+b)``
      (:func:`_fused_step`, with its ``any(lit)`` read where the skip rule
      applies); ``("iter", b, n)``: the ``n`` such steps ``s = 0, b, ...``
      of a compacted iteration at rung ``b`` (:func:`_op_waves`);
    * ``("sort",)``: the live-first sort after the peeled first bounce.

    A read is ``("read", "neff")`` (the live prefix length, once a
    compacted iteration) or ``("read", "live")`` (``any(window > 0)``, once
    a bounce without a budget)."""
    yield ("begin",)
    budget = _loop_budget(p, rs)
    if not budget:
        j = 0
        while j <= rs.max_bounce_count and (yield ("read", "live")):
            yield ("step", 0, p, j == 0)
            j += 1
        yield ("end",)
        return
    yield ("step", 0, p, True)     # j = 0
    yield ("sort",)
    rungs = _loop_rungs(p, budget, rs)
    j, ne = 1, None
    for i, b in enumerate(rungs):
        nxt = rungs[i + 1] if i + 1 < len(rungs) else 0
        while j <= rs.max_bounce_count:
            if ne is None:
                ne = yield ("read", "neff")
            if ne <= nxt:   # done, or the prefix fits the next rung
                break
            yield ("iter", b, -(-ne // b))
            j += 1
            ne = None
    yield ("end",)


def later_unit(op) -> bool:
    """Whether unit ``op`` (of :func:`loop_ops`, or a plan's half bounce
    ``shade``/``light``) bounces waves past the first bounce: an ``iter``,
    or a ``step``, ``shade`` or ``light`` whose ``primary`` is False."""
    return op[0] == "iter" or (op[0] in ("step", "shade", "light") and not op[3])


def _op_waves(op) -> list:
    """The waves ``(s, b, primary)`` of a ``step`` or ``iter`` unit."""
    if op[0] == "step":
        return [op[1:]]
    _, b, n = op
    return [(s, b, False) for s in range(0, n * b, b)]


def drive(ops, run, read) -> None:
    """Go through the schedule ``ops`` (:func:`loop_ops`): ``run(op)`` each
    unit, ``read(op)`` each read, whose value goes back to ``ops``."""
    value = None
    while True:
        try:
            op = ops.send(value)
        except StopIteration:
            return
        if op[0] == "read":
            value = read(op)
        else:
            run(op)
            value = None


def _loop_buffers(s_row: torch.Tensor, active0: torch.Tensor):
    """The fused loop's fresh buffers for a wave: ``(tmp, decay_p, win,
    miss)``, the ambient radiance (3, P, K), the per-packet decay (P,), the
    windows of the active lanes and the miss flags (P, K)."""
    p, k = active0.shape
    dev = active0.device
    tmp = torch.empty((3, p, k), dtype=torch.float32, device=dev)
    for c, a in enumerate(shade.ambient_tuple()):
        tmp[c] = a
    # per-packet decay: the spp fold keeps one sample index per packet
    decay_p = torch.pow(SAMPLE_DECAY, s_row)
    win = torch.where(active0, RAY_TMAX, 0.0)
    miss = torch.zeros((p, k), dtype=torch.int32, device=dev)
    return tmp, decay_p, win, miss


@spanned("rt.sort")
def _live_first(rays, win, tmp, miss, decay_p):
    """The one stable live-first sort of the packets after the peeled j=0
    -> the sorted ``(rays, win, tmp, miss, decay_p)`` and the inverse
    permutation."""
    plive = (win > 0.0).any(dim=1)
    order = torch.argsort((~plive).to(torch.int32), stable=True)
    inv = torch.argsort(order, stable=True)
    return (rays.index_select(1, order), win.index_select(0, order),
            tmp.index_select(1, order), miss.index_select(0, order),
            decay_p.index_select(0, order), inv)


@spanned("rt.sort")
def _frame_order(rays, tmp, miss, inv):
    """The loop's ``rays``, ``tmp`` and ``miss`` back in frame order."""
    return (rays.index_select(1, inv), tmp.index_select(1, inv),
            miss.index_select(0, inv))


class _FusedLoop:
    """The fused loop on one wave: ``rays`` (6, P, K), bounced in place,
    the per-packet sample index ``s_row`` (P,) and the active lanes
    ``active0`` (P, K). :meth:`run` enqueues a unit of :func:`loop_ops` on
    the loop's buffers, :meth:`reduction` a read's one-element tensor, and
    :meth:`read` reads it (one counted host sync). After ``("end",)``,
    ``result`` is ``(missed, d, radiance)`` of (P, K) for the sky. A wave
    is a view of the loop's buffers: the kernels take plane strides, so
    nothing is copied.

    A graph plan (``graphs.FramePlan``) also runs a bounce over a wave
    ``(s, b, primary)`` as the two halves of :func:`_fused_step`, with the
    ``any(lit)`` read (``("read", "lit", s, b, primary)``) between them:
    ``("shade", s, b, primary)`` and ``("light", s, b, primary,
    shadow)``."""

    def __init__(self, ts, rs, rays, s_row, active0, stats=None):
        self.ts, self.rs, self.stats = ts, rs, stats
        self.rays, self.s_row, self.active0 = rays, s_row, active0

    def run(self, op):
        """Enqueue unit ``op`` -> what later units and reads take from it
        (a shade unit's outputs, the result) or None. A unit past the first
        bounce (:func:`later_unit`) runs inside an ``rt.later`` span, its
        sweeps (K1 and K2, or K8 and K9) counting into their later slots
        (``_build.later_waves``)."""
        if later_unit(op):
            with span("rt.later"), _build.later_waves():
                return self._unit(op)
        return self._unit(op)

    def _unit(self, op):
        ts, rs, stats = self.ts, self.rs, self.stats
        kind = op[0]
        if kind == "begin":
            self.tmp, self.decay, self.win, self.miss = _loop_buffers(
                self.s_row, self.active0)
            self.inv = None
        elif kind in ("step", "iter"):
            for s, b, primary in _op_waves(op):
                _fused_step(ts, rs, self.rays[:, s:s + b], self.win[s:s + b],
                            self.tmp[:, s:s + b], self.miss[s:s + b],
                            self.decay[s:s + b], stats, primary)
        elif kind == "shade":
            s, b, primary = op[1:]
            self.shaded = _shade_wave(ts, rs, self.rays[:, s:s + b],
                                      self.win[s:s + b], self.miss[s:s + b],
                                      stats, primary)
            return self.shaded
        elif kind == "light":
            s, b, primary, shadow = op[1:]
            _light_wave(ts, rs, self.shaded, self.win[s:s + b],
                        self.tmp[:, s:s + b], self.decay[s:s + b], stats,
                        primary, shadow)
        elif kind == "sort":
            (self.rays, self.win, self.tmp, self.miss, self.decay,
             self.inv) = _live_first(self.rays, self.win, self.tmp, self.miss,
                                     self.decay)
            self.rows1 = torch.arange(1, self.win.shape[0] + 1,
                                      device=self.win.device)
        elif kind == "end":
            rays, tmp, miss = self.rays, self.tmp, self.miss
            if self.inv is not None:
                rays, tmp, miss = _frame_order(rays, tmp, miss, self.inv)
            # at loop exit d is each miss lane's miss direction (no carry)
            self.result = (miss != 0, (rays[3], rays[4], rays[5]),
                           (tmp[0], tmp[1], tmp[2]))
            return self.result
        else:
            raise ValueError(f"no unit {op!r}")
        return None

    def reduction(self, op) -> torch.Tensor:
        """The one-element tensor read ``op`` reads."""
        what = op[1]
        if what == "lit":
            return (self.shaded[3] != 0).any()
        if what == "live":
            return (self.win > 0.0).any()
        # the live prefix length: last live row + 1
        return torch.where((self.win > 0.0).any(dim=1), self.rows1, 0).max()

    def read(self, op):
        return _read(self.reduction(op), self.stats)


def _trace_sample_fused(ts: TorchScene, rs: RenderStatic, rays: torch.Tensor,
                        s_row: torch.Tensor, active0: torch.Tensor,
                        stats: Optional[dict] = None):
    """The bounce loop on the packed ABI with the fused shade and
    accumulate passes (``integrator._trace_sample_fused`` :379-572) over
    ``rays`` (6, P, K), updated in place, and the per-packet sample index
    ``s_row`` (P,) -> ``(missed, d, radiance)`` of (P, K) for the sky
    (:func:`_deferred_sky`): :func:`loop_ops`'s schedule, each unit run as
    it comes.

    With ``wavefront="compact"`` and a budget (P >= 128): the peeled j=0
    runs full width, then ONE stable live-first sort of the packets; later
    iterations run over disjoint waves of ``b`` packets that cover only the
    live prefix (liveness is monotone, so the live packets stay a prefix),
    phase by phase down the rung ladder; the inverse permutation restores
    frame order. The frame equals the full-width loop's bit for bit but for
    exact ties, as in :func:`_trace_sample`."""
    loop = _FusedLoop(ts, rs, rays, s_row, active0, stats)
    drive(loop_ops(active0.shape[0], rs), loop.run, loop.read)
    return loop.result


def render_packets(ts: TorchScene, rs: RenderStatic, camera: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor, active0: torch.Tensor,
                   rays6: Optional[torch.Tensor] = None,
                   stats: Optional[dict] = None):
    """Render packets of pixels ``px``/``py`` (P, K) -> Vec3 color (P, K),
    sample-averaged (``integrator.render_packets`` :901-970). With
    ``rs.fold_spp`` (and spp > 1) all spp sample waves are folded into the
    packet axis, interleaved (packet t*spp + s = tile t, sample s), and the
    colors are their mean; else one wave of the P packets a sample, sample
    index i on every packet, and the colors are their sum scaled by 1/spp
    (:951-970), which may round apart from the mean.

    ``rays6`` replaces the raygen: the packed (6, spp*P, K) primary rays in
    the folded layout (left unchanged; the unfolded loop takes sample i's
    packets ``rays6[:, i::spp]``). ``stats``, if a dict, receives device
    counters of the rays traced (``closest_rays``, ``shadow_rays``), the
    host count ``host_syncs``, all summed over the waves, and the sweeps'
    ``tier`` of one wave (:func:`frame_tier`); the per-lane sweeps then
    count their work too (``_build.work_counts``)."""
    p, k = px.shape
    spp = rs.samples_per_pixel
    if stats is not None:
        stats.setdefault("host_syncs", 0)
    with _build.counting(stats is not None):
        if not _folds(rs):
            return _render_samples(ts, rs, camera, px, py, active0, rays6, stats)
        if stats is not None:
            stats["tier"] = frame_tier(ts, p * spp, k)
        colors = _trace_wave(ts, rs, camera, *_folded_rows(px, py, active0, spp),
                             rays6, stats)
        return tuple(c.reshape(p, spp, k).mean(dim=1) for c in colors)


def _folds(rs: RenderStatic) -> bool:
    """Whether :func:`render_packets` renders the samples as one wave: the
    spp fold, or one sample."""
    return rs.fold_spp or rs.samples_per_pixel == 1


def _folded_rows(px, py, active0, spp: int):
    """The spp fold's wave of packets ``px``/``py``/``active0`` (P, K):
    ``(px, py, active, s_row)`` of spp * P packets, packet t*spp + s = tile
    t, sample s."""
    rows = tuple(x.repeat_interleave(spp, dim=0) for x in (px, py, active0))
    s_row = torch.arange(spp, dtype=torch.float32,
                         device=px.device).repeat(px.shape[0])
    return (*rows, s_row)


def _render_samples(ts, rs, camera, px, py, active0, rays6, stats):
    """The unfolded loop (``render_packets.sample_body`` :951-970): one wave
    of the P packets per sample, colors summed, then scaled by 1/spp. The
    tier and the fused choice are those of a P-packet wave."""
    p, k = px.shape
    spp = rs.samples_per_pixel
    if stats is not None:
        stats["tier"] = frame_tier(ts, p, k)
    accum = None
    for i in range(spp):
        s_row = torch.full((p,), float(i), dtype=torch.float32, device=px.device)
        rays_i = None if rays6 is None else rays6[:, i::spp].contiguous()
        colors = _trace_wave(ts, rs, camera, px, py, active0, s_row, rays_i,
                             stats)
        accum = colors if accum is None else v3.add(accum, colors)
    return v3.scale(1.0 / spp, accum)


def _trace_wave(ts, rs, camera, px, py, act, s_row, rays6, stats):
    """One wave of packets ``px``/``py`` (P, K) with per-packet sample index
    ``s_row`` (P,): the raygen (unless ``rays6`` gives its rays, which are
    left unchanged), then the fused loop or the XLA body, then the sky ->
    Vec3 color."""
    p, k = px.shape
    spp = rs.samples_per_pixel
    fused = _use_fused(ts, p, k)
    if rays6 is None:
        with span("rt.raygen"):
            rays6 = _KERNELS["raygen"](camera, s_row, px, py, spp, rs.width,
                                       rs.height)
    elif fused:
        rays6 = rays6.clone()  # the fused loop bounces the rays in place
    with span("rt.loop"):
        if fused:
            missed, d, tmp = _trace_sample_fused(ts, rs, rays6, s_row, act, stats)
        else:
            missed, d, tmp = _trace_sample(
                ts, rs, (rays6[0], rays6[1], rays6[2]),
                (rays6[3], rays6[4], rays6[5]), s_row[:, None], act, stats)
    return _deferred_sky(ts, rs, missed, d, tmp, stats)


def render_pixels(ts: TorchScene, rs: RenderStatic, camera: torch.Tensor,
                  pix: torch.Tensor, stats: Optional[dict] = None) -> torch.Tensor:
    """Colors of the pixels ``pix`` (R, 2) ``(x, y)`` -> (R, 3) f32
    (``integrator.render_pixels`` :976): the list in packets of
    ``min(packet_size, R)`` lanes, padded to whole packets and to a
    ``SEG_PACKETS`` multiple of them with dead lanes, through
    :func:`render_packets`."""
    r = pix.shape[0]
    k = min(rs.packet_size, r)
    lanes = -(-r // k) * k
    p = lanes // k
    p_pad = p + (-p) % SEG_PACKETS
    xy = torch.zeros((p_pad * k, 2), dtype=torch.float32, device=pix.device)
    xy[:r] = pix.to(torch.float32)
    active0 = (torch.arange(p_pad * k, device=pix.device) < r).reshape(p_pad, k)
    colors = render_packets(ts, rs, camera, xy[:, 0].reshape(p_pad, k),
                            xy[:, 1].reshape(p_pad, k), active0, stats=stats)
    return torch.stack(colors, dim=-1).reshape(-1, 3)[:r]


def tiled_pixels(rs: RenderStatic, device):
    """Tile-major pixel packets (``integrator._tiled_pixels`` :1002):
    ``(px, py)`` (P, K) f32 and the in-frame lane mask, the packet count
    padded to a ``SEG_PACKETS`` multiple with dead packets."""
    t = rs.tile
    h_t, w_t = _tile_grid(rs)
    ty, tx = torch.meshgrid(torch.arange(h_t, device=device),
                            torch.arange(w_t, device=device), indexing="ij")
    iy, ix = torch.meshgrid(torch.arange(t, device=device),
                            torch.arange(t, device=device), indexing="ij")
    xs = tx.reshape(-1, 1) * t + ix.reshape(1, -1)
    ys = ty.reshape(-1, 1) * t + iy.reshape(1, -1)
    in_frame = (xs < rs.width) & (ys < rs.height)
    px = torch.clamp_max(xs, rs.width - 1).to(torch.float32)
    py = torch.clamp_max(ys, rs.height - 1).to(torch.float32)
    pad = frame_packets(rs) - px.shape[0]
    if pad:
        zf = torch.zeros((pad, px.shape[1]), dtype=torch.float32, device=device)
        px = torch.cat([px, zf])
        py = torch.cat([py, zf])
        in_frame = torch.cat([in_frame, zf.bool()])
    return (px, py), in_frame


@spanned("rt.detile")
def detile(colors, rs: RenderStatic) -> torch.Tensor:
    """Packets -> (H, W, 3) image by reshape/permute (padding dropped)."""
    t = rs.tile
    h_t, w_t = _tile_grid(rs)
    planes = [
        c[: h_t * w_t]
        .reshape(h_t, w_t, t, t)
        .permute(0, 2, 1, 3)
        .reshape(h_t * t, w_t * t)[: rs.height, : rs.width]
        for c in colors
    ]
    return torch.stack(planes, dim=-1)


def _tile_grid(rs: RenderStatic):
    """The frame's tiles: ``(rows, columns)``."""
    return -(-rs.height // rs.tile), -(-rs.width // rs.tile)


def frame_packets(rs: RenderStatic) -> int:
    """The packets of :func:`tiled_pixels`: the frame's tiles, padded to a
    ``SEG_PACKETS`` multiple."""
    h_t, w_t = _tile_grid(rs)
    return h_t * w_t + (-h_t * w_t) % SEG_PACKETS


def frame_chunk(rs: RenderStatic) -> int:
    """Packets a chunk of :func:`render_frame` (0: the frame is one)."""
    if not rs.ray_chunk:
        return 0
    chunk = max(1, rs.ray_chunk // rs.packet_size)
    chunk = -(-chunk // SEG_PACKETS) * SEG_PACKETS
    return chunk if chunk < frame_packets(rs) else 0


def one_fused_wave(ts: TorchScene, rs: RenderStatic) -> bool:
    """Whether :func:`render_frame` renders a frame as one wave of the
    fused loop: one chunk (:func:`frame_chunk`), the samples folded
    (:func:`_folds`), the fused loop taken (:func:`_use_fused`)."""
    return (not frame_chunk(rs) and _folds(rs) and _use_fused(
        ts, frame_packets(rs) * rs.samples_per_pixel, rs.packet_size))


def render_frame(ts: TorchScene, rs: RenderStatic, camera: torch.Tensor,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """Full frame -> (H, W, 3) f32 image on the scene's device.

    With ``rs.ray_chunk`` (``integrator.render_frame`` :1064-1088) the
    packets go through :func:`render_packets` in chunks of
    ``max(1, ray_chunk // packet_size)`` packets, rounded up to a
    ``SEG_PACKETS`` multiple, when that is fewer than the frame's: the
    frame is padded with dead packets to whole chunks, and ``stats`` sums
    over the chunks."""
    (px, py), in_frame = tiled_pixels(rs, ts.device)
    p = px.shape[0]
    chunk = frame_chunk(rs)
    if not chunk:
        colors = render_packets(ts, rs, camera, px, py, in_frame, stats=stats)
        return detile(colors, rs)
    pad = (-p) % chunk
    if pad:
        px, py, in_frame = (torch.cat([x, x.new_zeros((pad, x.shape[1]))])
                            for x in (px, py, in_frame))
    parts = [render_packets(ts, rs, camera, px[s:s + chunk], py[s:s + chunk],
                            in_frame[s:s + chunk], stats=stats)
             for s in range(0, p + pad, chunk)]
    colors = tuple(torch.cat([c[i] for c in parts])[:p] for i in range(3))
    return detile(colors, rs)
