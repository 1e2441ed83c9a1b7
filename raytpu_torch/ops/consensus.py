"""Consensus sweeps: K8 and K9 of the JAX package's megakernel tier
(counterpart of ``raytpu/ops/mega.py:954`` ``mega_closest_sweep`` and
``:1216`` ``mega_anyhit_sweep``; they live here rather than in
``ops/mega.py`` because the plain walks of ``ops/traverse.py`` import the
scene module, which imports ``ops/mega.py``).

They compute the chained sweeps' function (the closest hit over every
entry merged into the 9-plane state with strict ``t < best_t``; occlusion
within ``(tmin, tmax)`` OR-merged into ``occ``) on the per-lane tier's
schedule (``ops/perlane.prepass``: K7 and the block bitmask, the block's
octant, entries in stable depth order or the shadow ``order``), and walk as
the TPU megakernel does:

* a group of lanes walks an entry's tree with one node pointer; each lane
  tests the box of every node, leaves included, against its own window,
  and the group descends, or tests a leaf's triangles for all its lanes,
  where any lane's box hits (``raytpu/ops/mega.py:640-716``, ``:1033``);
  a shadow group stops once all its lanes are occluded;
* along the scene's wide links ``wide_succ``/``wide_skip``
  (``ops/mega.widen_octant_links``).

The group is the warp, :data:`WARP` consecutive lanes, where the TPU groups
the spp packets of a tile: the hits do not depend on the grouping (a
lane's candidates only grow, and Moller-Trumbore is exact per lane), only
the speed and which of two triangles hit at exactly the same t is kept.

The wrappers take a CPU tensor to the plain version, launch K7 and the
kernel of ``csrc/consensus.cu`` for a CUDA tensor (or raise), and raise
unless the wave is whole blocks of ``BLOCK_PACKETS`` whose lanes are whole
warps. The kernels read the scene's packed records (``packed_nodes``,
``packed_tris``) with the wide links packed ``{succ, skip}``
(``packed_wide``); a scene without them raises. The plain versions walk
the same groups in the same order (``ops/traverse.closest_ref``/
``anyhit_ref`` with ``consensus=WARP``), so kernel and plain version agree
bit for bit, and the ``counts`` hook counts the kernel's box tests of live
lanes and their triangle tests, and those of them the lanes' own walks
need (``own_nodes``, ``own_tests``: ``traverse._walk``).

While this thread counts work (``_build.counting``: a frame rendered with
``stats``), the kernels count those four numbers on the card and the plain
versions count the plain walk's, into the same ``_build.work_counts``; a
wave past the first bounce (``_build.later_waves``) into each sweep's own
later slot of ``_build.work_pointer``, so that its entry
``mega_closest_sweep.later`` or ``mega_anyhit_sweep.later`` holds the later
waves alone and its own entry still every wave.
"""

from __future__ import annotations

import torch

from raytpu_torch import _build
from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops import perlane
from raytpu_torch.ops.mega import BLOCK_PACKETS, check_blocks
from raytpu_torch.ops.traverse import ST_T, WARP, anyhit_ref, closest_ref


def wide_links(ts: TorchScene):
    """The scene's wide links ``(succ, skip)``; raises if it has none."""
    if ts.wide_succ is None or ts.wide_skip is None:
        raise ValueError("the consensus sweeps need the scene's wide links "
                         "(attach_bvh or from_raytpu builds them)")
    return ts.wide_succ, ts.wide_skip


def check_warps(kernel: str, rays: torch.Tensor) -> None:
    """Raise unless ``rays`` (6, P, K) is whole blocks of whole warps."""
    check_blocks(kernel, rays.shape[1])
    if BLOCK_PACKETS * rays.shape[2] % WARP:
        raise ValueError(f"{kernel}: a block of {BLOCK_PACKETS} packets of "
                         f"{rays.shape[2]} lanes is not whole warps of {WARP}")


def mega_closest_sweep(ts: TorchScene, rays: torch.Tensor, tmin: float,
                       state: torch.Tensor) -> torch.Tensor:
    """Closest hit of ``rays`` (6, P, K) over the entries in depth order,
    culled by block, walked by warps along the wide links, merged into
    ``state`` (9, P, K) in place; returns ``state``. CPU tensors take
    :func:`mega_closest_sweep_ref`; CUDA tensors launch K7 and
    ``rt_mega_closest_sweep``."""
    if rays.device.type == "cpu":
        return mega_closest_sweep_ref(ts, rays, tmin, state)
    check_warps("mega_closest_sweep", rays)
    return launch_closest(ts, rays, tmin, state, perlane.prepass(
        ts, rays, state[ST_T], tmin, "origin"))


def launch_closest(ts: TorchScene, rays: torch.Tensor, tmin: float,
                   state: torch.Tensor, schedule) -> torch.Tensor:
    """K8 alone, on a ``perlane.prepass`` ``schedule`` of these rays."""
    k = "mega_closest_sweep"
    t = ts.bvh_tri_v0.shape[0]
    tables = perlane.culled_operands(k, ts, rays, schedule)
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        *_build.check_planes(k, "state", state, (9, *rays.shape[1:])),
        rays[0].numel(), float(tmin), *tables,
        _build.check_operand(k, "bvh_tri_n_soa", ts.bvh_tri_n_soa, (9, t)),
        t, perlane.visit_counters(k, rays.device),
    )
    return state


def mega_anyhit_sweep(ts: TorchScene, rays: torch.Tensor, tmin: float,
                      tmax: torch.Tensor, occ: torch.Tensor,
                      order: str = "light") -> torch.Tensor:
    """Occlusion of ``rays`` (6, P, K) within ``(tmin, tmax)`` over the
    entries in ``order``, culled by block, walked by warps along the wide
    links, OR-merged into the int32 ``occ`` (P, K) in place; returns
    ``occ``. CPU tensors take :func:`mega_anyhit_sweep_ref`; CUDA tensors
    launch K7 and ``rt_mega_anyhit_sweep``."""
    if rays.device.type == "cpu":
        return mega_anyhit_sweep_ref(ts, rays, tmin, tmax, occ, order)
    check_warps("mega_anyhit_sweep", rays)
    return launch_anyhit(ts, rays, tmin, tmax, occ,
                         perlane.prepass(ts, rays, tmax, tmin, order))


def launch_anyhit(ts: TorchScene, rays: torch.Tensor, tmin: float,
                  tmax: torch.Tensor, occ: torch.Tensor,
                  schedule) -> torch.Tensor:
    """K9 alone, on a ``perlane.prepass`` ``schedule`` of these rays."""
    k = "mega_anyhit_sweep"
    tables = perlane.culled_operands(k, ts, rays, schedule)
    _build.launch(
        k,
        *_build.check_planes(k, "rays", rays, (6, *rays.shape[1:])),
        _build.check_operand(k, "tmax", tmax, rays.shape[1:]),
        _build.check_operand(k, "occ", occ, rays.shape[1:], torch.int32),
        rays[0].numel(), float(tmin), *tables,
        perlane.visit_counters(k, rays.device),
    )
    return occ


def kernel_attributes() -> dict:
    """K8's and K9's registers, local bytes, resident CTAs and SMs
    (:func:`raytpu_torch._build.kernel_attributes`)."""
    return _build.kernel_attributes(
        "rt_consensus_attributes", ("mega_closest_sweep", "mega_anyhit_sweep"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def mega_closest_sweep_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                           state: torch.Tensor, slots=None,
                           counts=None) -> torch.Tensor:
    """Plain PyTorch :func:`mega_closest_sweep`: the plain consensus walk
    with the per-lane schedule over the wide links. ``slots`` and
    ``counts`` as for ``traverse.closest_sweep_ref``."""
    check_warps("mega_closest_sweep", rays)
    rows, walks, links = perlane.plain_schedule(
        ts, rays, state[ST_T], tmin, "origin", wide_links(ts))
    with _build.counted("mega_closest_sweep", counts) as c:
        return closest_ref(ts, rays, tmin, state, rows, walks, links, slots,
                           c, consensus=WARP)


def mega_anyhit_sweep_ref(ts: TorchScene, rays: torch.Tensor, tmin: float,
                          tmax: torch.Tensor, occ: torch.Tensor,
                          order: str = "light",
                          counts=None) -> torch.Tensor:
    """Plain PyTorch :func:`mega_anyhit_sweep`."""
    check_warps("mega_anyhit_sweep", rays)
    rows, walks, links = perlane.plain_schedule(ts, rays, tmax, tmin, order,
                                                wide_links(ts))
    with _build.counted("mega_anyhit_sweep", counts) as c:
        return anyhit_ref(ts, rays, tmin, tmax, occ, rows, walks, links, c,
                          consensus=WARP)
