"""Device-resident scene for the PyTorch port (counterpart of
``raytpu/device_scene.py``).

:class:`TorchScene` holds only what the Whitted frame reads: the instance
transforms and materials, the light, the packed RGB8 sky, the shading
normals, and the threaded ``bvh_*`` arrays with an ENTRY TABLE that lists,
per (instance, traversal mesh) in ``traversal_list`` order, the instance,
its material, and the mesh's node base, node count and triangle base. The
sweeps walk that table in one launch. Beside the skip links, each mesh's
nodes are threaded once per ray-direction octant, near child first
(``oct_succ``/``oct_skip``, ``ops/mega.octant_links``) for the per-lane
tier, and once more with every other interior level dropped
(``wide_succ``/``wide_skip``, ``ops/mega.widen_octant_links``) for the
consensus tier; ``traversal`` and ``auto_tier`` say which tier the sweeps
take. The per-lane tier's kernels read the roots and triangles as packed
16-byte records (``packed_*``, :func:`with_packed`), the same bits as the
tables they come from, and each inner node's children as one 64-byte
child-pair record with its near child per octant taken from the octant
links (``packed_pairs``, :func:`pack_pairs`); the consensus tier's read the
same node and triangle records with the wide links packed, and the
chained sweeps and the one-mesh walks the same node and triangle records
with ``bvh_miss``.

Every scene keeps each mesh's primitive range (``mesh_prim_ranges``). A
scene with no BVH (:func:`brute_scene`, ``traversal="brute"`` or
``bvh_builder="brute"``, ``raytpu/render.py:32``) also keeps its triangles
in primitive order, packed as the BVH's are (``tri_packed``), which the
brute-force tracers read (``ops/intersect.brute_closest``), and has one
entry per (instance, mesh) whose node columns name no nodes: node_base 0,
node_count the mesh's triangle count, tri_base its first primitive.

Layouts match the JAX package, so buffers compare by a reshape: nodes are
concatenated over meshes with mesh-local ``bvh_miss`` and ``bvh_tri_first``
(``raytpu/ops/traverse.py:64,114``), triangles are in BVH-slot order, and
the sky is one u32 word per texel, carried as int32 bits (PyTorch has no
full uint32 arithmetic).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raytpu_torch.ops.mega import mesh_octant_links, mesh_wide_links
from raytpu_torch.scene import Scene

ENTRY_COLS = ("inst", "mat", "node_base", "node_count", "tri_base")


@dataclasses.dataclass(frozen=True)
class TorchScene:
    """All device tensors of a scene, plus its static shape facts."""

    device: torch.device
    o2w: torch.Tensor              # (N, 3, 4) f32 object -> world
    w2o: torch.Tensor              # (N, 3, 4) f32 world -> object
    materials: torch.Tensor        # (N,) int32 0 diffuse / 1 mirror / 2 refract
    light_pos: torch.Tensor        # (3,) f32
    light_intensity: torch.Tensor  # () f32
    tri_n_soa: torch.Tensor        # (9, T) f32 corner normals, prim order
    skybox_u32: torch.Tensor       # (6*H*W,) int32 bits of R | G<<8 | B<<16
    sky_hw: Tuple[int, int]
    instance_mesh: Tuple[int, ...]
    # light_pos xyz and light_intensity as host floats (each an exact f32
    # value): the shade and accumulate kernels take them as arguments, so a
    # launch reads nothing back from the device
    light: Tuple[float, float, float, float]
    # the 2x bilinear-prefiltered sky of the "bilinear2x" filter
    # (pack_skybox_2x), (6*2H*2W,) int32 words: four times the sky's bytes
    # (100.7 MB for a 6x1024x1024 sky), so built only for a scene whose
    # config asks for that filter (None otherwise)
    skybox_u32_2x: Optional[torch.Tensor] = None
    # threaded BVH, concatenated over traversal meshes (None until attached)
    bvh_aabb_min: Optional[torch.Tensor] = None   # (M, 3) f32
    bvh_aabb_max: Optional[torch.Tensor] = None   # (M, 3) f32
    bvh_tri_first: Optional[torch.Tensor] = None  # (M,) int32 mesh-local, -1 inner
    bvh_tri_count: Optional[torch.Tensor] = None  # (M,) int32
    bvh_miss: Optional[torch.Tensor] = None       # (M,) int32 mesh-local skip link
    bvh_tri_v0: Optional[torch.Tensor] = None     # (T, 3) f32 BVH-slot order
    bvh_tri_e1: Optional[torch.Tensor] = None     # (T, 3)
    bvh_tri_e2: Optional[torch.Tensor] = None     # (T, 3)
    bvh_tri_prim: Optional[torch.Tensor] = None   # (T,) int32 global prim id
    bvh_tri_n_soa: Optional[torch.Tensor] = None  # (9, T) f32 BVH-slot order
    entries: Optional[torch.Tensor] = None        # (E, 5) int32, ENTRY_COLS
    # per-octant near-first links, mesh-local like bvh_miss
    oct_succ: Optional[torch.Tensor] = None       # (8, M) int32
    oct_skip: Optional[torch.Tensor] = None       # (8, M) int32
    # the same links with every other interior level dropped (the consensus
    # walk's wide links, ops/mega.widen_octant_links)
    wide_succ: Optional[torch.Tensor] = None      # (8, M) int32
    wide_skip: Optional[torch.Tensor] = None      # (8, M) int32
    # the packed records of K1/K2 (with the child pairs), of K8/K9 (with
    # the wide links) and of K10a-K11b (with bvh_miss), the bits of the
    # tables above laid out for 16-byte loads (with_packed)
    packed_nodes: Optional[torch.Tensor] = None   # (M, 8) f32, pack_nodes
    packed_pairs: Optional[torch.Tensor] = None   # (M, 16) f32, pack_pairs
    packed_wide: Optional[torch.Tensor] = None    # (8, M, 2) int32, pack_links
    packed_tris: Optional[torch.Tensor] = None    # (T, 12) f32, pack_tris
    traversal_list: Tuple[Tuple[int, int], ...] = ()
    # the triangles in primitive order as (T, 12) f32 records (pack_tris),
    # the brute tracers' table: a scene with no BVH only (prim_tris)
    tri_packed: Optional[torch.Tensor] = None
    # each mesh's (first primitive, count)
    mesh_prim_ranges: Tuple[Tuple[int, int], ...] = ()
    # the rows of ``entries`` on the host: the per-(instance, mesh) loop
    # (ops/trace.closest_hit_loop) reads them without a device sync
    entry_rows: Tuple[Tuple[int, int, int, int, int], ...] = ()
    leaf_max: int = 0              # largest leaf (the plain walk's unroll)
    # inner levels of the deepest tree: the stack entries K1/K2's pair walk
    # needs (pack_pairs)
    pair_depth: int = 0
    # RenderConfig.traversal, and the tier "auto" resolves to ("perlane" or
    # "mega", accel.resolve_auto_tier)
    traversal: str = "auto"
    auto_tier: str = "mega"

    @property
    def has_bvh(self) -> bool:
        """Whether a BVH is attached (else every sweep is brute force)."""
        return self.bvh_aabb_min is not None

    def with_transforms(self, o2w: np.ndarray, w2o: np.ndarray) -> "TorchScene":
        """Per-frame instance transform update (the refit analog): a new
        scene."""
        return dataclasses.replace(
            self,
            o2w=torch.as_tensor(np.asarray(o2w, np.float32), device=self.device),
            w2o=torch.as_tensor(np.asarray(w2o, np.float32), device=self.device),
        )

    def to(self, device) -> "TorchScene":
        """This scene on ``device``: every tensor field (the ``bvh_*`` and
        packed tables, the skies, the entries, octant and wide links, the
        transforms) copied there, the host fields kept. On the scene's own
        device, a copy that shares the tensors. Either way a new object:
        one replica per slot of a sharded frame."""
        device = torch.device(device)
        if device == self.o2w.device:
            return dataclasses.replace(self)
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, device=device, **moved)


def corner_tables(scene: Scene):
    """Per-triangle corner data in primitive order, as
    ``raytpu.device_scene.build_device_scene`` computes it:
    ``(v0, e1, e2)`` each (T, 3) f32 and ``tri_n_soa`` (9, T) f32."""
    g = scene.geometry
    tri = g.triangles.astype(np.int64)
    p, n = g.positions, g.normals
    v0, v1, v2 = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    n_soa = np.concatenate(
        [n[tri[:, 0]].T, n[tri[:, 1]].T, n[tri[:, 2]].T], axis=0
    ).astype(np.float32)
    return v0, v1 - v0, v2 - v0, np.ascontiguousarray(n_soa)


def pack_skybox(skybox: Optional[np.ndarray]) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(6, H, W, 3) float sky -> ((6*H*W,) int32 RGB8 words, (H, W)),
    quantized exactly as ``raytpu.device_scene`` does (black 1x1 if None)."""
    if skybox is None:
        skybox = np.zeros((6, 1, 1, 3), np.float32)
    sky8 = np.clip(np.asarray(skybox, np.float32) * 255.0 + 0.5, 0, 255)
    sky8 = sky8.astype(np.uint32)
    words = (sky8[..., 0] | (sky8[..., 1] << 8) | (sky8[..., 2] << 16))
    return words.reshape(-1).view(np.int32), (skybox.shape[1], skybox.shape[2])


def pack_skybox_2x(skybox: Optional[np.ndarray]) -> np.ndarray:
    """(6, H, W, 3) float sky -> (6*2H*2W,) int32 RGB8 words of its 2x
    bilinear prefilter, as ``raytpu.device_scene.build_device_scene``
    (:245-272) computes it: per face the separable half-texel upsample in
    f32, then ``+0.5``, clip and pack. A single tap into it is bilinear
    filtering with weights on the half-texel grid."""
    if skybox is None:
        skybox = np.zeros((6, 1, 1, 3), np.float32)
    skybox = np.asarray(skybox, np.float32)
    fh, fw = skybox.shape[1], skybox.shape[2]

    def upsample_axis(img, axis, size):
        pos = np.clip((np.arange(2 * size, dtype=np.float32) - 0.5) / 2.0,
                      0, size - 1)
        i0 = np.floor(pos).astype(np.int64)
        i1 = np.minimum(i0 + 1, size - 1)
        w = (pos - i0).astype(np.float32)
        a = np.take(img, i0, axis=axis)
        b = np.take(img, i1, axis=axis)
        shape = [1] * img.ndim
        shape[axis] = 2 * size
        w = w.reshape(shape)
        return a * (1 - w) + b * w

    words = np.empty((6, 2 * fh * 2 * fw), np.uint32)
    for f in range(6):
        face2 = upsample_axis(upsample_axis(skybox[f], 0, fh), 1, fw)
        f8 = np.clip(face2 * 255.0 + 0.5, 0, 255).astype(np.uint32)
        words[f] = (f8[..., 0] | (f8[..., 1] << 8) | (f8[..., 2] << 16)).reshape(-1)
    return words.reshape(-1).view(np.int32)


def host_light(pos, intensity) -> Tuple[float, float, float, float]:
    """The light as four host floats, each rounded to f32 as the device
    copies are."""
    vals = np.concatenate([np.asarray(pos, np.float32).reshape(3),
                           np.asarray(intensity, np.float32).reshape(1)])
    return tuple(float(x) for x in vals)


def pack_nodes(bmin: torch.Tensor, bmax: torch.Tensor, first: torch.Tensor,
               count: torch.Tensor) -> torch.Tensor:
    """(M, 8) f32 node records, two 16-byte words a node: ``{bmin xyz,
    first}`` and ``{bmax xyz, count}``, the int32 fields' bits carried in
    f32 words (assembled as int32, so every bit pattern stays)."""
    i32 = torch.int32
    return torch.cat((bmin.view(i32), first[:, None], bmax.view(i32),
                      count[:, None]), dim=1).view(torch.float32).contiguous()


def pack_links(succ: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """(8, M, 2) int32 ``{succ, skip}`` words of (8, M) links (the wide
    links): an inner node's walk takes ``succ`` on a box hit and ``skip`` on
    a miss, a leaf's always ``skip``."""
    return torch.stack((succ, skip), dim=-1).contiguous()


def pack_tris(v0: torch.Tensor, e1: torch.Tensor,
              e2: torch.Tensor) -> torch.Tensor:
    """(T, 12) f32 triangle records in BVH-slot order, three 16-byte words
    ``{v0, 0}``, ``{e1, 0}``, ``{e2, 0}``."""
    pad = torch.zeros((v0.shape[0], 1), dtype=v0.dtype, device=v0.device)
    return torch.cat((v0, pad, e1, pad, e2, pad), dim=1).contiguous()


def pack_pairs(ts: TorchScene):
    """K1/K2's child-pair records of ``ts``'s trees and the stack they
    need: ``(pairs, depth)``. ``pairs`` is (M, 16) f32, four 16-byte words
    a row; the row of inner node ``g``, whose children are ``a`` (row
    ``g + 1``, the build order's first) and ``b`` (``a``'s ``bvh_miss``),
    holds ``{a_min, a_ref}``, ``{a_max, a_count << 8 | near}``, ``{b_min,
    b_ref}``, ``{b_max, b_count}``: the children's boxes bit for bit, a
    leaf child's mesh-local first slot and count, an inner child's ``~id``
    (its mesh-local id complemented, so negative) and count 0, and ``near``,
    whose bit ``o`` says that ``a`` is the near child for octant ``o``:
    ``a`` is where ``oct_succ`` continues on a box hit, the ``pick_l`` of
    ``ops/mega.octant_links``. A leaf's row is zero (never read). ``depth``
    counts the inner levels of the deepest tree (0 for trees that are one
    leaf). Vectorized over the nodes; the loops run over the trees and the
    levels."""
    first, miss = ts.bvh_tri_first, ts.bvh_miss.long()
    dev, m = first.device, first.shape[0]
    trees = sorted({(nb, nc) for _, _, nb, nc, _ in ts.entry_rows})
    base = torch.zeros(m, dtype=torch.long, device=dev)
    for nb, nc in trees:
        base[nb:nb + nc] = nb
    inner = (first < 0).nonzero().squeeze(1)
    a = inner + 1
    b = base[inner] + miss[a]
    near = ts.oct_succ[:, inner].long() == (a - base[inner])      # (8, I)
    near = (near.long() << torch.arange(8, device=dev)[:, None]).sum(0)
    i32 = torch.int32

    def ref_count(c):
        leaf = first[c] >= 0
        ref = torch.where(leaf, first[c], ~(c - base[inner]).to(i32))
        return ref, torch.where(leaf, ts.bvh_tri_count[c], 0).long()

    if ts.leaf_max >= 1 << 23:
        raise ValueError(f"pack_pairs: a leaf of {ts.leaf_max} triangles does "
                         "not fit the record's 23 bits")
    (a_ref, a_count), (b_ref, b_count) = ref_count(a), ref_count(b)
    box = (ts.bvh_aabb_min.view(i32), ts.bvh_aabb_max.view(i32))
    words = torch.zeros((m, 16), dtype=i32, device=dev)
    words[inner] = torch.cat((
        box[0][a], a_ref[:, None], box[1][a],
        ((a_count << 8) | near).to(i32)[:, None],
        box[0][b], b_ref[:, None], box[1][b], b_count.to(i32)[:, None]), dim=1)

    kid = torch.full((m, 2), -1, dtype=torch.long, device=dev)
    kid[inner] = torch.stack((a, b), dim=1)
    level = torch.tensor([nb for nb, _ in trees], dtype=torch.long, device=dev)
    depth = 0
    while True:
        level = level[first[level] < 0]
        if not level.numel():
            return words.view(torch.float32), depth
        depth += 1
        level = kid[level].reshape(-1)


def with_packed(ts: TorchScene) -> TorchScene:
    """``ts`` with the packed records of K1/K2, K8/K9 and K10a-K11b built
    from its ``bvh_*`` tables, octant links and wide links (once per scene:
    they do not depend on the transforms)."""
    pairs, depth = pack_pairs(ts)
    return dataclasses.replace(
        ts,
        packed_nodes=pack_nodes(ts.bvh_aabb_min, ts.bvh_aabb_max,
                                ts.bvh_tri_first, ts.bvh_tri_count),
        packed_pairs=pairs,
        pair_depth=depth,
        packed_wide=pack_links(ts.wide_succ, ts.wide_skip),
        packed_tris=pack_tris(ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2))


def build_device_scene(scene: Scene, device) -> TorchScene:
    """Host :class:`raytpu_torch.scene.Scene` -> :class:`TorchScene` on ``device``
    (no BVH yet: :func:`raytpu_torch.accel.attach_bvh` adds it); the 2x sky
    only where ``scene.config.skybox_filter`` is "bilinear2x", and
    ``tri_packed`` only where the config asks for no BVH ("brute")."""
    device = torch.device(device)
    cfg = scene.config
    anim = scene.animation()
    v0, e1, e2, n_soa = corner_tables(scene)
    sky, sky_hw = pack_skybox(scene.skybox)

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    prim_ranges = []
    for mesh_id in range(scene.geometry.num_meshes):
        _, ps = scene.geometry.mesh_slice(mesh_id)
        prim_ranges.append((int(ps.start), int(ps.stop - ps.start)))

    return TorchScene(
        device=device,
        o2w=dev(anim.transforms_3x4(), np.float32),
        w2o=dev(anim.inverse_transforms_3x4(), np.float32),
        materials=dev(scene.material_types, np.int32),
        light_pos=dev(cfg.light_position, np.float32),
        light_intensity=dev(cfg.light_intensity, np.float32),
        tri_n_soa=dev(n_soa),
        skybox_u32=dev(sky),
        sky_hw=(int(sky_hw[0]), int(sky_hw[1])),
        instance_mesh=tuple(inst.mesh_id for inst in scene.instances),
        light=host_light(cfg.light_position, cfg.light_intensity),
        skybox_u32_2x=(dev(pack_skybox_2x(scene.skybox))
                       if cfg.skybox_filter == "bilinear2x" else None),
        tri_packed=(pack_tris(*(dev(x, np.float32) for x in (v0, e1, e2)))
                    if "brute" in (cfg.bvh_builder, cfg.traversal) else None),
        mesh_prim_ranges=tuple(prim_ranges),
    )


# the fields a BVH attaches (accel.attach_bvh), which brute_scene drops
BVH_FIELDS = ("bvh_aabb_min", "bvh_aabb_max", "bvh_tri_first", "bvh_tri_count",
              "bvh_miss", "bvh_tri_v0", "bvh_tri_e1", "bvh_tri_e2",
              "bvh_tri_prim", "bvh_tri_n_soa", "oct_succ", "oct_skip",
              "wide_succ", "wide_skip", "packed_nodes", "packed_pairs",
              "packed_wide", "packed_tris")


def prim_tris(ts: TorchScene) -> torch.Tensor:
    """``ts``'s triangles in primitive order as (T, 12) records: its
    ``tri_packed``, or else its BVH's triangle records put back in
    primitive order through ``bvh_tri_prim`` (the same bits)."""
    if ts.tri_packed is not None:
        return ts.tri_packed
    if not ts.has_bvh:
        raise ValueError("the scene has neither tri_packed nor a BVH: build it "
                         "from a config with traversal or bvh_builder 'brute'")
    n = ts.tri_n_soa.shape[1]
    out = torch.zeros((n, 12), dtype=torch.float32, device=ts.device)
    out[ts.bvh_tri_prim.long()] = pack_tris(ts.bvh_tri_v0, ts.bvh_tri_e1,
                                            ts.bvh_tri_e2)
    return out


def brute_scene(ts: TorchScene) -> TorchScene:
    """``ts`` with no BVH, as raytpu's Renderer leaves a scene under
    ``traversal="brute"`` or ``bvh_builder="brute"`` (``raytpu/render.py:32``):
    every BVH table dropped, the triangles in primitive order
    (:func:`prim_tris`), and the entries one per (instance, mesh) in
    ``traversal_list`` order from ``mesh_prim_ranges``: node_base 0,
    node_count the mesh's triangle count, tri_base its first primitive.
    Every sweep of such a scene is the per-(instance, mesh) loop over the
    brute tracers (``integrator._tier``)."""
    traversal_list = tuple(enumerate(ts.instance_mesh))
    ranges = ts.mesh_prim_ranges
    entries = entry_table(traversal_list, ts.materials.cpu().numpy(),
                          [(0, count) for _, count in ranges], ranges)
    return dataclasses.replace(
        ts, **dict.fromkeys(BVH_FIELDS), leaf_max=0, tri_packed=prim_tris(ts),
        traversal_list=traversal_list,
        entries=torch.as_tensor(entries, device=ts.device),
        entry_rows=tuple(map(tuple, entries.tolist())))


def entry_table(traversal_list, materials, node_ranges, tri_ranges) -> np.ndarray:
    """(E, 5) int32 rows (inst, mat, node_base, node_count, tri_base), one
    per (instance, traversal mesh) in ``traversal_list`` order."""
    rows = [
        (inst, int(materials[inst]), node_ranges[mesh][0],
         node_ranges[mesh][1], tri_ranges[mesh][0])
        for inst, mesh in traversal_list
    ]
    return np.asarray(rows, np.int32).reshape(-1, len(ENTRY_COLS))


def from_raytpu(dev, static, device) -> TorchScene:
    """Carry a JAX ``DeviceScene`` + ``SceneStatic`` across unchanged: the
    same chunked ``bvh_*`` arrays, the same ``traversal_list`` and the same
    traversal tier, so both packages walk the identical trees in the
    identical order. The octant links, plain and wide, are threaded per
    chunk. raytpu builds every scene's 2x sky, and it comes across too.

    ``dev``/``static`` are read through ``np.asarray`` only; this module
    never imports JAX."""
    if not static.mesh_node_ranges:
        raise ValueError("from_raytpu needs a raytpu scene with a BVH")
    device = torch.device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)  # a writable copy

    materials = np.asarray(dev.materials, np.int32)
    count = np.asarray(dev.bvh_tri_count)
    first, miss = np.asarray(dev.bvh_tri_first), np.asarray(dev.bvh_miss)
    succ, skip = mesh_octant_links(
        np.asarray(dev.bvh_aabb_min), np.asarray(dev.bvh_aabb_max), first,
        miss, static.mesh_node_ranges)
    wide = mesh_wide_links(succ, skip, first, miss, static.mesh_node_ranges)
    entries = entry_table(static.traversal_list, materials,
                          static.mesh_node_ranges, static.mesh_bvh_tri_ranges)
    return with_packed(TorchScene(
        device=device,
        o2w=t(dev.o2w),
        w2o=t(dev.w2o),
        materials=t(materials),
        light_pos=t(dev.light_pos),
        light_intensity=t(dev.light_intensity),
        tri_n_soa=t(dev.tri_n_soa),
        skybox_u32=t(np.asarray(dev.skybox_u32).view(np.int32)),
        skybox_u32_2x=t(np.asarray(dev.skybox_u32_2x).view(np.int32)),
        sky_hw=tuple(int(x) for x in static.sky_hw),
        instance_mesh=tuple(static.instance_mesh),
        light=host_light(dev.light_pos, dev.light_intensity),
        bvh_aabb_min=t(dev.bvh_aabb_min),
        bvh_aabb_max=t(dev.bvh_aabb_max),
        bvh_tri_first=t(dev.bvh_tri_first),
        bvh_tri_count=t(count),
        bvh_miss=t(dev.bvh_miss),
        bvh_tri_v0=t(dev.bvh_tri_v0),
        bvh_tri_e1=t(dev.bvh_tri_e1),
        bvh_tri_e2=t(dev.bvh_tri_e2),
        bvh_tri_prim=t(dev.bvh_tri_prim),
        bvh_tri_n_soa=t(dev.bvh_tri_n_soa),
        entries=t(entries),
        entry_rows=tuple(map(tuple, entries.tolist())),
        oct_succ=t(succ),
        oct_skip=t(skip),
        wide_succ=t(wide[0]),
        wide_skip=t(wide[1]),
        traversal_list=tuple(static.traversal_list),
        mesh_prim_ranges=tuple(tuple(int(x) for x in r)
                               for r in static.mesh_prim_ranges),
        leaf_max=int(count.max()),
        traversal=static.traversal,
        auto_tier=static.auto_tier,
    ))
