"""Scene assembly: meshes → concatenated device arrays + instances + animation.

The port's own copy of ``raytpu/scene.py`` (the port imports nothing of
``raytpu``; the skybox loader is ``raytpu_torch.io.image``'s), plus
:func:`scene_from_raytpu`, which carries a raytpu host ``Scene`` across by
its attributes.

Reference analogs:

* **vertex/index concatenation** (C8, ``src/main.cpp:1657-1729``): the
  reference interleaves ``[px py pz nx ny nz]`` per vertex and concatenates
  both meshes into ONE vertex buffer and ONE index buffer, publishing two
  offsets to the shaders (``orbitingObjectPrimitiveOffset = indexList[0].size()/3``,
  ``orbitingObjectVertexOffset = attrib[0].vertices.size()*2``,
  ``src/main.cpp:1872-1873``; consumed at ``src/shader.rchit:50-61``). raytpu
  keeps SoA arrays (TPU-friendly layout) but preserves the same contract:
  concatenated ``positions``/``normals``/``triangles`` with per-mesh
  ``vertex_offset``/``primitive_offset``, and triangle indices rebased so the
  flat arrays are directly gatherable.
* **instances** (C10, ``src/main.cpp:538-551,1805-1825``): each instance
  carries a 3×4 affine transform, an ``instanceCustomIndex`` (its position in
  the instance list — used by the hit shader for offset/material selection)
  and a mesh id.
* **animation** (C18, ``src/main.cpp:2836-2844``): the center mesh
  *accumulates* a slow Y-rotation each frame (frame-rate dependent, by
  design of the reference); the orbiting mesh circles radius 10 about
  ``(0, 0, -5)`` as a pure function of ``timeParam``. :class:`AnimationState`
  reproduces both; per-frame "TLAS refit" is just handing the new (N, 3, 4)
  transform arrays to the jitted render — no rebuild, no sync, the TPU-first
  answer to the reference's synchronous refit+fence each frame
  (``src/main.cpp:2848-2861,730-778``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from raytpu_torch.config import MaterialType, ObjectConfig, RenderConfig
from raytpu_torch.io.image import load_skybox, read_image  # noqa: F401 (re-exported)
from raytpu_torch.io.obj import Mesh, load_obj


# ---------------------------------------------------------------------------
# small affine-matrix helpers (host-side, float64 like glm's float ops are
# float32 — we keep float64 and cast at upload for better accumulation)
# ---------------------------------------------------------------------------

def mat_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def mat_translate(v: Sequence[float]) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = v
    return m


def mat_rotate_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def affine_3x4(m: np.ndarray) -> np.ndarray:
    """Top 3 rows of a 4×4 — the ``VkTransformMatrixKHR`` layout the
    reference converts to at ``src/main.cpp:245-259``."""
    return np.asarray(m, dtype=np.float64)[:3, :4]


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 4×4 (or 3×4) affine transform → 3×4."""
    m4 = np.eye(4, dtype=np.float64)
    m4[:3, :4] = np.asarray(m, dtype=np.float64)[:3, :4]
    return np.linalg.inv(m4)[:3, :4]


# ---------------------------------------------------------------------------
# scene geometry (host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SceneGeometry:
    """Concatenated triangle soup for all meshes (C8 contract)."""

    positions: np.ndarray          # (V, 3) float32, all meshes concatenated
    normals: np.ndarray            # (V, 3) float32
    triangles: np.ndarray          # (T, 3) int32, indices into the FLAT arrays
    vertex_offsets: Tuple[int, ...]     # per mesh, in vertices
    primitive_offsets: Tuple[int, ...]  # per mesh, in triangles
    mesh_names: Tuple[str, ...]

    @property
    def num_meshes(self) -> int:
        return len(self.vertex_offsets)

    def mesh_slice(self, mesh_id: int) -> Tuple[slice, slice]:
        """(vertex_slice, triangle_slice) of one mesh in the flat arrays."""
        v0 = self.vertex_offsets[mesh_id]
        p0 = self.primitive_offsets[mesh_id]
        v1 = (
            self.vertex_offsets[mesh_id + 1]
            if mesh_id + 1 < self.num_meshes
            else self.positions.shape[0]
        )
        p1 = (
            self.primitive_offsets[mesh_id + 1]
            if mesh_id + 1 < self.num_meshes
            else self.triangles.shape[0]
        )
        return slice(v0, v1), slice(p0, p1)


def assemble_geometry(meshes: Sequence[Mesh]) -> SceneGeometry:
    """Concatenate meshes, rebasing triangle indices into the flat arrays
    (mirrors ``src/main.cpp:1664-1729``; the published offsets correspond to
    ``orbitingObjectPrimitiveOffset``/``orbitingObjectVertexOffset`` at
    ``src/main.cpp:1872-1873``, generalised to N meshes)."""
    positions, normals, tris = [], [], []
    v_offsets, p_offsets, names = [], [], []
    v_acc = p_acc = 0
    for mesh in meshes:
        v_offsets.append(v_acc)
        p_offsets.append(p_acc)
        names.append(mesh.name)
        positions.append(mesh.positions)
        normals.append(mesh.normals)
        tris.append(mesh.triangles.astype(np.int64) + v_acc)
        v_acc += mesh.num_vertices
        p_acc += mesh.num_triangles
    return SceneGeometry(
        positions=np.concatenate(positions, axis=0).astype(np.float32),
        normals=np.concatenate(normals, axis=0).astype(np.float32),
        triangles=np.concatenate(tris, axis=0).astype(np.int32),
        vertex_offsets=tuple(v_offsets),
        primitive_offsets=tuple(p_offsets),
        mesh_names=tuple(names),
    )


# ---------------------------------------------------------------------------
# instances + animation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Instance:
    """One placed mesh (``VkAccelerationStructureInstanceKHR`` analog,
    ``src/main.cpp:538-551``). ``custom_index`` is the instance's position in
    the scene list, used for material/offset selection exactly like
    ``gl_InstanceCustomIndexEXT`` (``src/shader.rchit:52``)."""

    mesh_id: int
    material: MaterialType
    animation: str = "static"
    transform: np.ndarray = dataclasses.field(default_factory=mat_identity)  # 4×4


class AnimationState:
    """Per-frame instance transform update (``src/main.cpp:2836-2844``).

    * ``spin``: M ← M · rotY(timeParam·π·1e-4) — **accumulates** per frame,
      matching the reference's frame-rate-dependent center-mesh spin;
    * ``orbit``: M = T(0,0,−5) · rotY(timeParam·π) · T(0,0,10) — pure
      function of time (initial pose T(0,0,5) == t=0, ``src/main.cpp:1805-1807``);
    * ``static``: initial transform unchanged.
    """

    def __init__(self, instances: Sequence[Instance]):
        self.instances = list(instances)
        self.matrices = [inst.transform.copy() for inst in instances]

    def step(self, time_param: float) -> np.ndarray:
        for i, inst in enumerate(self.instances):
            if inst.animation == "spin":
                self.matrices[i] = self.matrices[i] @ mat_rotate_y(
                    time_param * math.pi * 1e-4
                )
            elif inst.animation == "orbit":
                self.matrices[i] = (
                    mat_translate((0, 0, -5))
                    @ mat_rotate_y(time_param * math.pi)
                    @ mat_translate((0, 0, 10))
                )
            # "static": keep
        return self.transforms_3x4()

    def transforms_3x4(self) -> np.ndarray:
        return np.stack([affine_3x4(m) for m in self.matrices]).astype(np.float32)

    def inverse_transforms_3x4(self) -> np.ndarray:
        return np.stack([invert_affine(m) for m in self.matrices]).astype(np.float32)


# ---------------------------------------------------------------------------
# full host scene
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scene:
    geometry: SceneGeometry
    meshes: List[Mesh]
    instances: List[Instance]
    skybox: Optional[np.ndarray]  # (6, H, W, 3) float32 or None
    config: RenderConfig

    @property
    def material_types(self) -> np.ndarray:
        return np.asarray([int(i.material) for i in self.instances], dtype=np.int32)

    def animation(self) -> AnimationState:
        return AnimationState(self.instances)


def _default_transform(animation: str) -> np.ndarray:
    # Initial instance transforms (src/main.cpp:1805-1807): identity for the
    # center mesh, T(0,0,5) for the orbiting mesh.
    if animation == "orbit":
        return mat_translate((0, 0, 5))
    return mat_identity()


def load_scene(
    config: RenderConfig,
    meshes: Optional[Sequence[Mesh]] = None,
    skybox: Optional[np.ndarray] = None,
) -> Scene:
    """Build a :class:`Scene` from a config, loading assets from disk unless
    pre-loaded ``meshes``/``skybox`` are injected (tests do this)."""
    if meshes is None:
        meshes = [load_obj(obj.path) for obj in config.objects]
    meshes = list(meshes)
    if len(meshes) != len(config.objects):
        raise ValueError("meshes/objects length mismatch")

    instances = [
        Instance(
            mesh_id=i,
            material=obj.material,
            animation=obj.animation,
            transform=_default_transform(obj.animation),
        )
        for i, obj in enumerate(config.objects)
    ]

    if skybox is None and config.skybox_dir is not None:
        skybox = load_skybox(config.skybox_dir)

    return Scene(
        geometry=assemble_geometry(meshes),
        meshes=meshes,
        instances=instances,
        skybox=skybox,
        config=config,
    )


# ---------------------------------------------------------------------------
# carrying a raytpu host scene across
# ---------------------------------------------------------------------------

def _fields(obj, cls) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def scene_from_raytpu(scene) -> Scene:
    """The port's :class:`Scene` holding the same numpy arrays as a raytpu
    host ``Scene``, read by its attributes (this module imports nothing of
    raytpu): geometry, meshes, instances with their transforms, skybox and
    the config, field for field."""
    cfg = scene.config
    objects = tuple(
        ObjectConfig(o.path, MaterialType(int(o.material)), o.animation)
        for o in cfg.objects
    )
    g = scene.geometry
    return Scene(
        geometry=SceneGeometry(**_fields(g, SceneGeometry)),
        meshes=[Mesh(**_fields(m, Mesh)) for m in scene.meshes],
        instances=[
            Instance(mesh_id=i.mesh_id, material=MaterialType(int(i.material)),
                     animation=i.animation, transform=i.transform)
            for i in scene.instances
        ],
        skybox=scene.skybox,
        config=RenderConfig(**{**_fields(cfg, RenderConfig), "objects": objects}),
    )
