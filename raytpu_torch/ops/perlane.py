"""Per-lane sweeps: K1 and K2 of the JAX package's per-lane tier
(counterpart of ``raytpu/ops/perlane.py:1633`` ``perlane_closest_sweep`` and
``:1862`` ``perlane_anyhit_sweep``).

They compute the chained sweeps' function (``ops/traverse.py``: the closest
hit over every entry merged into the 9-plane state with strict
``t < best_t``; occlusion within ``(tmin, tmax)`` OR-merged into ``occ``)
and take the JAX tier's schedule, which decides exact ties:

* per call, the prepass of ``ops/mega.py`` (on the card one launch of K7,
  ``block_schedule``; on the CPU :func:`plain_prepass`) gives a block hit
  bitmask, each block's octant and each entry's depth;
* entries in stable depth order (closest) or ``order`` (shadow, default
  ``"light"``, ``raytpu/integrator.py:129``);
* a lane skips an entry whose bit for its block is 0;
* inside an entry a lane walks near child first with its BLOCK's octant,
  in the order of the scene's ``oct_succ``/``oct_skip`` links (the TPU
  kernel's tie order; a ray's own octant is a later option).

The TPU kernel's treelet banks, quantized boxes and deferred-leaf queue are
TPU scheduling that only add candidate tests. The CUDA kernels
(``csrc/perlane.cu``) take its pair step: a lane standing at an entered
node loads one 64-byte record of both children (``packed_pairs``: their
boxes, references and the near child per octant), tests both boxes, takes
the near child and keeps the far one for after it, on a per-lane stack
where the near one is entered (the wrappers refuse a tree deeper than
:data:`PAIR_STACK`); it takes inner nodes until it reaches a leaf, then
the leaf, so a warp's lanes step and test together. It enters the same nodes
and tests the same triangles, in the same order, as the stackless walk of
the plain versions (``ops/traverse._walk`` along the octant links). They
read the roots and triangles as packed f32 records (``packed_nodes``,
``packed_tris``) and run as persistent warps that take 32 lanes at a time
from per-CTA work counters. The wrappers take a CPU tensor to the plain version,
launch the kernel for a CUDA tensor (or raise), and raise unless the wave
is whole blocks of ``BLOCK_PACKETS``.
The prepass's tensors stay on the device; only the plain versions read them
back.

While this thread counts work (``_build.counting``: a frame rendered with
``stats``), the kernels count their node visits, triangle tests and record
fetches on the card and the plain versions count the plain walk's, into
the same ``_build.work_counts`` (:func:`visit_counters`; the consensus
sweeps count their visits and tests so too).
"""

from __future__ import annotations

import torch

from raytpu_torch import _build
from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops.mega import (
    BLOCK_PACKETS,
    block_schedule,
    check_blocks,
    chunk_block_hits,
    entry_perm,
)
from raytpu_torch.ops.traverse import ST_T, anyhit_ref, closest_ref, packed_operands
from raytpu_torch.utils.spans import spanned


@spanned("rt.prepass")
def prepass(ts: TorchScene, rays: torch.Tensor, window: torch.Tensor,
            tmin: float, order: str):
    """The per-call schedule of a sweep: ``(bits, octs, entries)``, the
    bitmask rows (E, ceil(PB/32)) int32 and the entry rows (E, 5) int32,
    both in walk order, and the blocks' octants (PB,) int32. CPU tensors
    take :func:`plain_prepass`; others one launch of K7
    (``mega.block_schedule``: no other kernel, no host sync; a device other
    than CUDA is refused there)."""
    if rays.device.type == "cpu":
        return plain_prepass(ts, rays, window, tmin, order)
    return block_schedule(ts, rays, window, tmin, order)[:3]


@spanned("rt.prepass")
def plain_prepass(ts: TorchScene, rays: torch.Tensor, window: torch.Tensor,
                  tmin: float, order: str):
    """:func:`prepass` in plain PyTorch on any device, K7's oracle and the
    plain walks' prepass (so a CPU frame has its span too):
    ``chunk_block_hits`` and ``entry_perm``."""
    bits, octs, depth = chunk_block_hits(ts, rays, window, tmin)
    perm = entry_perm(ts, depth, order)
    return bits.index_select(0, perm), octs, ts.entries.index_select(0, perm)


def schedule_operands(k: str, rays, schedule):
    """The schedule's operands of the culled sweeps' C entry points (K1/K2,
    K8/K9): the lanes per block, the bitmask rows and their word count,
    and the blocks' octants."""
    bits, octs, _ = schedule
    c = _build.check_operand
    i32 = torch.int32
    return (
        BLOCK_PACKETS * rays.shape[2],
        c(k, "bits", bits, None, i32), bits.shape[1],
        c(k, "octs", octs, (rays.shape[1] // BLOCK_PACKETS,), i32),
    )


def _entry_operands(k: str, ts: TorchScene, schedule):
    """The entries in walk order, their count and w2o, checked."""
    entries = schedule[2]
    c = _build.check_operand
    return (c(k, "entries", entries, (entries.shape[0], 5), torch.int32),
            entries.shape[0], c(k, "w2o", ts.w2o, (ts.w2o.shape[0], 3, 4)))


def culled_operands(k: str, ts: TorchScene, rays, schedule):
    """The operands of the consensus sweeps' C entry points (K8/K9) after
    the per-call ones: the schedule, the scene's packed wide links
    ``packed_wide``, the node count, the entries in walk order and w2o, the
    packed nodes and triangles. The scene's tables are checked first."""
    m = ts.bvh_aabb_min.shape[0]
    links, nodes, tris = packed_operands(
        k, ts, ("packed_wide", ts.packed_wide, (8, m, 2), torch.int32))
    return (*schedule_operands(k, rays, schedule), links, m,
            *_entry_operands(k, ts, schedule), nodes, tris)


# the inner levels of a tree that K1/K2's pair walk can hold on its stack
# (csrc/perlane.cu, kStack)
PAIR_STACK = 64


def pair_operands(k: str, ts: TorchScene, rays, schedule):
    """The operands of K1/K2's C entry points after the per-call ones: the
    schedule, the entries in walk order and w2o, the packed nodes, child
    pairs and triangles. A scene whose trees have more inner levels than
    the walk's stack holds (``ts.pair_depth`` over :data:`PAIR_STACK`)
    raises; then the scene's tables are checked."""
    if ts.pair_depth > PAIR_STACK:
        raise ValueError(
            f"{k}: a tree of {ts.pair_depth} inner levels is deeper than the "
            f"pair walk's stack of {PAIR_STACK}")
    m = ts.bvh_aabb_min.shape[0]
    pairs, nodes, tris = packed_operands(
        k, ts, ("packed_pairs", ts.packed_pairs, (m, 16), torch.float32),
        link_align=16)
    return (*schedule_operands(k, rays, schedule),
            *_entry_operands(k, ts, schedule), nodes, pairs, tris)


# work counters a persistent launch may use, one per CTA: more than the
# CTAs of 256 threads that fit on an H100 at once (132 SMs x 8)
WORK_SLOTS = 2048


def _work_counters(device) -> torch.Tensor:
    """The work counters of a persistent launch, one u32 per CTA (int32
    here), zeroed on the stream by the C entry point."""
    return torch.empty(WORK_SLOTS, dtype=torch.int32, device=device)


def visit_counters(k: str, device):
    """Where launch ``k`` (K1, K2, K8 or K9) adds its work counts: the
    kernel's slot of ``_build``'s buffer while this thread counts, else
    None (the kernel that counts nothing)."""
    return _build.work_pointer(k, device) if _build.counting_on() else None


def perlane_closest_sweep(ts: TorchScene, rays: torch.Tensor, tmin: float,
                          state: torch.Tensor) -> torch.Tensor:
    """Closest hit of ``rays`` (6, P, K) over the entries in depth order,
    culled by block and walked near child first, merged into ``state``
    (9, P, K) in place; returns ``state``. CPU tensors take
    :func:`perlane_closest_sweep_ref`; CUDA tensors launch K7 and
    ``rt_perlane_closest_sweep``."""
    if rays.device.type == "cpu":
        return perlane_closest_sweep_ref(ts, rays, tmin, state)
    check_blocks("perlane_closest_sweep", rays.shape[1])
    return launch_closest(ts, rays, tmin, state,
                          prepass(ts, rays, state[ST_T], tmin, "origin"))


def launch_closest(ts: TorchScene, rays: torch.Tensor, tmin: float,
                   state: torch.Tensor, schedule) -> torch.Tensor:
    """K1 alone, on a :func:`prepass` ``schedule`` of these rays."""
    k = "perlane_closest_sweep"
    t = ts.bvh_tri_v0.shape[0]
    tables = pair_operands(k, ts, rays, schedule)
    taken = _work_counters(rays.device)
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        *_build.check_planes(k, "state", state, (9, *rays.shape[1:])),
        rays[0].numel(), float(tmin), *tables,
        _build.check_operand(k, "bvh_tri_n_soa", ts.bvh_tri_n_soa, (9, t)),
        t, taken.data_ptr(), WORK_SLOTS, visit_counters(k, rays.device),
    )
    return state


def perlane_anyhit_sweep(ts: TorchScene, rays: torch.Tensor, tmin: float,
                         tmax: torch.Tensor, occ: torch.Tensor,
                         order: str = "light") -> torch.Tensor:
    """Occlusion of ``rays`` (6, P, K) within ``(tmin, tmax)`` over the
    entries in ``order``, culled by block, OR-merged into the int32 ``occ``
    (P, K) in place; returns ``occ``. CPU tensors take
    :func:`perlane_anyhit_sweep_ref`; CUDA tensors launch K7 and
    ``rt_perlane_anyhit_sweep``."""
    if rays.device.type == "cpu":
        return perlane_anyhit_sweep_ref(ts, rays, tmin, tmax, occ, order)
    check_blocks("perlane_anyhit_sweep", rays.shape[1])
    return launch_anyhit(ts, rays, tmin, tmax, occ,
                         prepass(ts, rays, tmax, tmin, order))


def launch_anyhit(ts: TorchScene, rays: torch.Tensor, tmin: float,
                  tmax: torch.Tensor, occ: torch.Tensor,
                  schedule) -> torch.Tensor:
    """K2 alone, on a :func:`prepass` ``schedule`` of these rays."""
    k = "perlane_anyhit_sweep"
    tables = pair_operands(k, ts, rays, schedule)
    taken = _work_counters(rays.device)
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        _build.check_operand(k, "tmax", tmax, rays.shape[1:]),
        _build.check_operand(k, "occ", occ, rays.shape[1:], torch.int32),
        rays[0].numel(), float(tmin), *tables, taken.data_ptr(), WORK_SLOTS,
        visit_counters(k, rays.device),
    )
    return occ


def kernel_attributes() -> dict:
    """K1's and K2's registers, local bytes, resident CTAs and SMs
    (:func:`raytpu_torch._build.kernel_attributes`); the persistent grid is
    the product of the last two."""
    return _build.kernel_attributes(
        "rt_perlane_attributes", ("perlane_closest_sweep", "perlane_anyhit_sweep"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def plain_schedule(ts: TorchScene, rays, window, tmin: float, order: str,
                   links=None):
    """The prepass through K7's plain version, as the plain walks take it:
    entry rows in walk order, which lanes walk each row (E, P*K) bool, and
    the ``links`` (succ, skip; default the scene's octant links) at each
    lane's block octant."""
    p, k = rays.shape[1:]
    check_blocks("per-lane sweep", p)
    succ, skip = links or (ts.oct_succ, ts.oct_skip)
    bits, octs, entries = plain_prepass(ts, rays, window, tmin, order)
    block = torch.arange(p * k, device=rays.device) // (BLOCK_PACKETS * k)
    walks = ((bits[:, block >> 5].long() >> (block & 31)) & 1).bool()
    base = octs.long()[block] * succ.shape[1]
    return (entries.cpu().tolist(), walks,
            (succ.reshape(-1), skip.reshape(-1), base))


def perlane_closest_sweep_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                              state: torch.Tensor, slots=None,
                              counts=None) -> torch.Tensor:
    """Plain PyTorch :func:`perlane_closest_sweep`: the plain closest walk
    (``ops/traverse.closest_ref``) with the per-lane schedule. ``slots``
    and ``counts`` as for ``traverse.closest_sweep_ref``."""
    rows, walks, links = plain_schedule(ts, rays, state[ST_T], tmin, "origin")
    with _build.counted("perlane_closest_sweep", counts) as c:
        return closest_ref(ts, rays, tmin, state, rows, walks, links, slots, c)


def perlane_anyhit_sweep_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                             tmax: torch.Tensor, occ: torch.Tensor,
                             order: str = "light",
                             counts=None) -> torch.Tensor:
    """Plain PyTorch :func:`perlane_anyhit_sweep`."""
    rows, walks, links = plain_schedule(ts, rays, tmax, tmin, order)
    with _build.counted("perlane_anyhit_sweep", counts) as c:
        return anyhit_ref(ts, rays, tmin, tmax, occ, rows, walks, links, c)
