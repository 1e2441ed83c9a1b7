"""BVH attachment for the PyTorch port (counterpart of
``raytpu/accel/__init__.py:26-147`` and ``resolve_auto_tier`` :302).

One threaded tree per mesh, or per chunk of a mesh, with its per-octant
links for the per-lane tier and their wide rethreading for the consensus
tier, built as ``RenderConfig.bvh_builder`` says (:40-75): "auto" and
"native" by the native SAH builder (``accel/native.py``), "sah" and
"median" by the host builders of ``accel/bvh.py``, "lbvh" by the device
LBVH of ``accel/lbvh.py`` on the scene's device. raytpu's "auto" falls back
to its Python "sah" where its native library is missing; the port builds
its native library from source or raises, so that fallback never applies.
"brute" attaches no tree (``device_scene.brute_scene``; the Renderer
decides, as ``raytpu/render.py:32`` does).

Chunks (:93-124): with ``RenderConfig.chunk_tris = N > 0`` a mesh of more
than N triangles is cut into Morton-ordered chunks of at most N
(``accel/chunking.py``), each with its own tree, octant and wide links,
packed records and entry, one entry per (instance, chunk), instance-major;
``bvh_tri_prim`` maps each slot back to its global primitive through the
chunk's Morton selection. ``chunk_tris=0`` keeps one tree per mesh.
raytpu's default for 0 (``needs_chunking``, chunks sized to the 1 MB of
scalar memory its TPU kernels keep a tree in) is TPU memory scheduling and
is not ported: a GPU thread walks a whole mesh's tree from device memory.
Nor is the separate shadow chunk set (``CHUNK_TRIS_SHADOW``): occlusion is
an OR that no partition changes, so the shadow sweeps walk the same
entries. To walk raytpu's own chunked trees, use
:func:`raytpu_torch.device_scene.from_raytpu`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from raytpu_torch.scene import Scene
from raytpu_torch.accel import bvh as host_bvh
from raytpu_torch.accel import native
from raytpu_torch.accel.chunking import chunk_order
from raytpu_torch.accel.lbvh import build_lbvh
from raytpu_torch.accel.native import Bvh, build_bvh
from raytpu_torch.device_scene import (
    TorchScene,
    corner_tables,
    entry_table,
    with_packed,
)
from raytpu_torch.ops.mega import mesh_octant_links, mesh_wide_links

__all__ = ["BVH_BUILDERS", "Bvh", "attach_bvh", "build_bvh", "resolve_auto_tier"]

# RenderConfig.bvh_builder's values that build a tree (mesh_builder);
# "brute" builds none
BVH_BUILDERS = ("auto", "native", "sah", "median", "lbvh")

# the largest leaf raytpu's traversal unrolls (raytpu/ops/intersect.py:56,
# the same environment override as RenderConfig.leaf_size); attach_bvh
# refuses larger leaves as raytpu's does (accel/__init__.py:54-58)
LEAF_UNROLL = int(os.environ.get("RAYTPU_LEAF_SIZE", "12"))


def resolve_auto_tier(total_tris: int, spp: int, bounces: int) -> str:
    """The tier ``traversal="auto"`` takes (``raytpu/accel/__init__.py:302``,
    the JAX package's measured preset table): the per-lane tier for scenes
    of at least 65,536 triangles and for spp-1 scenes with bounces, the
    consensus megakernel ("mega") for the rest."""
    if total_tris >= 65536:
        return "perlane"
    if spp == 1 and bounces >= 1:
        return "perlane"
    return "mega"


def mesh_builder(method: str, leaf_size: int, device):
    """``build(v0, e1, e2) -> Bvh`` of the builder ``method`` (a
    ``RenderConfig.bvh_builder`` value)."""
    if method in ("auto", "native"):
        return lambda v0, e1, e2: native.build_bvh(v0, e1, e2, leaf_size)
    if method in ("sah", "median"):
        return lambda v0, e1, e2: host_bvh.build_bvh(
            v0, e1, e2, leaf_size=leaf_size, method=method)
    if method == "lbvh":
        return lambda v0, e1, e2: build_lbvh(v0, e1, e2, leaf_size, device)
    raise ValueError(f"bvh_builder={method!r}: use one of {BVH_BUILDERS}")


def mesh_pieces(v0, e1, e2, chunk_tris: int) -> list:
    """The mesh-local triangle selections a mesh's trees are built over:
    one, the whole mesh in order, unless ``chunk_tris > 0`` and the mesh
    has more triangles, then its Morton-ordered chunks (:93-101)."""
    count = v0.shape[0]
    if chunk_tris and count > chunk_tris:
        order, ranges = chunk_order(v0, e1, e2, chunk_tris)
        return [order[s:s + c] for s, c in ranges]
    return [np.arange(count, dtype=np.int64)]


def attach_bvh(tscene: TorchScene, scene: Scene, leaf_size: int) -> TorchScene:
    """Build one tree per mesh of ``scene``, or per chunk of one under
    ``chunk_tris`` (:func:`mesh_pieces`), with the builder its config
    names (:func:`mesh_builder`), concatenate the ``bvh_*`` arrays (node
    and slot indices stay local to their tree), thread each tree per
    octant, plain and wide, pack the per-lane sweeps' records, fill the
    entry table, one entry per (instance, tree of its mesh), and resolve
    the traversal tier from the scene's config."""
    if leaf_size > LEAF_UNROLL:
        raise ValueError(
            f"leaf_size {leaf_size} exceeds traversal LEAF_UNROLL {LEAF_UNROLL}")
    chunk_tris = scene.config.chunk_tris
    if chunk_tris < 0:
        raise ValueError(f"chunk_tris={chunk_tris}: use 0 (one tree a mesh) "
                         "or a positive triangle count")
    build = mesh_builder(scene.config.bvh_builder, leaf_size, tscene.device)
    v0_all, e1_all, e2_all, n_soa = corner_tables(scene)
    nodes = {k: [] for k in ("aabb_min", "aabb_max", "tri_first",
                             "tri_count", "miss")}
    v0s, e1s, e2s, prims = [], [], [], []
    node_ranges, tri_ranges = [], []
    mesh_trees = []   # per mesh, the ids of its trees (chunks)
    node_acc = tri_acc = 0
    for mesh_id in range(scene.geometry.num_meshes):
        _, ps = scene.geometry.mesh_slice(mesh_id)
        v0, e1, e2 = v0_all[ps], e1_all[ps], e2_all[ps]
        trees = []
        for sel in mesh_pieces(v0, e1, e2, chunk_tris):
            cv0, ce1, ce2 = v0[sel], e1[sel], e2[sel]
            bvh = build(cv0, ce1, ce2)
            trees.append(len(node_ranges))
            node_ranges.append((node_acc, bvh.num_nodes))
            tri_ranges.append((tri_acc, bvh.num_triangles))
            node_acc += bvh.num_nodes
            tri_acc += bvh.num_triangles
            for k in nodes:
                nodes[k].append(getattr(bvh, k))
            order = bvh.tri_order.astype(np.int64)
            v0s.append(cv0[order])
            e1s.append(ce1[order])
            e2s.append(ce2[order])
            # -> global prim ids through the chunk's Morton selection
            prims.append((sel[order] + ps.start).astype(np.int32))
        mesh_trees.append(trees)

    prim = np.concatenate(prims)
    traversal_list = tuple((inst, tree)
                           for inst, mesh in enumerate(tscene.instance_mesh)
                           for tree in mesh_trees[mesh])
    materials = tscene.materials.cpu().numpy()
    arrays = {k: np.concatenate(v) for k, v in nodes.items()}
    succ, skip = mesh_octant_links(arrays["aabb_min"], arrays["aabb_max"],
                                   arrays["tri_first"], arrays["miss"],
                                   node_ranges)
    wide = mesh_wide_links(succ, skip, arrays["tri_first"], arrays["miss"],
                           node_ranges)
    cfg = scene.config
    entries = entry_table(traversal_list, materials, node_ranges, tri_ranges)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=tscene.device)

    return with_packed(dataclasses.replace(
        tscene,
        bvh_aabb_min=dev(arrays["aabb_min"]),
        bvh_aabb_max=dev(arrays["aabb_max"]),
        bvh_tri_first=dev(arrays["tri_first"]),
        bvh_tri_count=dev(arrays["tri_count"]),
        bvh_miss=dev(arrays["miss"]),
        bvh_tri_v0=dev(np.concatenate(v0s)),
        bvh_tri_e1=dev(np.concatenate(e1s)),
        bvh_tri_e2=dev(np.concatenate(e2s)),
        bvh_tri_prim=dev(prim),
        bvh_tri_n_soa=dev(n_soa[:, prim.astype(np.int64)]),
        entries=dev(entries),
        entry_rows=tuple(map(tuple, entries.tolist())),
        oct_succ=dev(succ),
        oct_skip=dev(skip),
        wide_succ=dev(wide[0]),
        wide_skip=dev(wide[1]),
        traversal_list=traversal_list,
        leaf_max=int(arrays["tri_count"].max()),
        traversal=cfg.traversal,
        auto_tier=resolve_auto_tier(tri_acc, cfg.samples_per_pixel,
                                    cfg.max_bounce_count),
    ))
