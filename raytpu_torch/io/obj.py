"""Wavefront OBJ mesh ingestion.

TPU-native equivalent of the reference's tinyobjloader usage
(``src/main.cpp:51-63,1606-1654`` over ``include/tiny_obj_loader.h``):

* only positions (``v``) and normals (``vn``) are consumed; texcoords and
  MTL materials are parsed-then-ignored by the reference (it drops everything
  but ``vertex_index`` at ``src/main.cpp:1648``), and we mirror that;
* all shapes/objects in a file are concatenated into one triangle soup, as the
  reference accumulates every shape's indices into a single flat list
  (``src/main.cpp:1640-1654``);
* faces with more than 3 vertices are fan-triangulated (tinyobjloader's
  default triangulation);
* **normal indexing quirk**: the reference fetches a vertex's normal at the
  *vertex index*, not the ``vn`` index — the interleave loop reads
  ``attrib.normals[3*v]`` (``src/main.cpp:1671-1682``) and the hit shader
  reads the same interleaved slot (``src/shader.rchit:69-86``). That is only
  correct for meshes whose ``vn`` list is position-aligned (true for all
  shipped assets: ``cube.obj`` duplicates vertices per face for flat normals,
  ``teapot.obj`` has 1:1 ``v``/``vn``). We reproduce this exactly when the
  alignment holds, and fall back to explicit ``vn``-index resolution (or
  computed smooth normals) when it does not — strictly more robust, never
  less faithful on reference assets.

The port's own copy of ``raytpu/io/obj.py`` (the port imports nothing of
``raytpu``), with its policy for the C++ parser (``io/native.py``, built
from ``native/objparse.cpp`` at first use): taken whenever it is available.
The native parser reads numbers with ``strtof``; the Python parser rounds
``float()``'s double to f32, which can differ in the last bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


def parse_mtl(path: str) -> dict:
    """Parse a Wavefront MTL file → {material_name: {key: values}}.

    Parity-with-quirk: the reference parses MTL files via tinyobjloader but
    its shading IGNORES them entirely (materials are fetched and dropped,
    ``src/main.cpp:1648`` keeps only vertex indices; shading constants are
    hard-coded in the shader, ``src/shader.rgen:51-55``). raytpu does the
    same: materials are parsed and attached to the Mesh for API parity and
    future use, but the integrator shades from the reference constants.
    """
    materials: dict = {}
    current = None
    try:
        fh = open(path, "r", errors="replace")
    except FileNotFoundError:
        return materials
    with fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                current = parts[1] if len(parts) > 1 else ""
                materials[current] = {}
            elif current is not None:
                key = parts[0]
                vals = []
                for tok in parts[1:]:
                    try:
                        vals.append(float(tok))
                    except ValueError:
                        vals.append(tok)
                materials[current][key] = vals if len(vals) != 1 else vals[0]
    return materials


@dataclasses.dataclass
class Mesh:
    """A triangle mesh: SoA arrays ready for device upload.

    ``positions``/``normals`` are per-vertex and index-aligned (the
    interleaved-buffer contract of ``src/main.cpp:1671-1682``);
    ``triangles`` is an (T, 3) int32 vertex-index array.
    """

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray    # (V, 3) float32
    triangles: np.ndarray  # (T, 3) int32
    name: str = ""
    # parsed-but-unused-for-shading MTL materials (reference quirk parity)
    materials_info: dict = dataclasses.field(default_factory=dict)

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.positions.min(axis=0), self.positions.max(axis=0)

    def validate(self) -> None:
        assert self.positions.ndim == 2 and self.positions.shape[1] == 3
        assert self.normals.shape == self.positions.shape
        assert self.triangles.ndim == 2 and self.triangles.shape[1] == 3
        if self.num_triangles:
            assert self.triangles.min() >= 0
            assert self.triangles.max() < self.num_vertices


def _resolve_index(raw: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices are relative to the end."""
    return raw - 1 if raw > 0 else count + raw


def compute_smooth_normals(positions: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (fallback when a mesh ships no
    usable ``vn`` data; the reference would read garbage in that case —
    ``src/main.cpp:1671-1682`` never checks)."""
    v0 = positions[triangles[:, 0]]
    v1 = positions[triangles[:, 1]]
    v2 = positions[triangles[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)  # length ∝ 2·area → area weighting
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, triangles[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens = np.where(lens > 0, lens, 1.0)
    return (normals / lens).astype(np.float32)


def load_obj(path: str, use_native: Optional[bool] = None) -> Mesh:
    """Parse an OBJ file into a :class:`Mesh` (``raytpu/io/obj.py:133``).

    ``use_native``: ``None`` takes the C++ parser when its library is built
    or can be built here, ``True`` forces it (and raises if it cannot be
    built), ``False`` takes the Python parser."""
    if use_native is None or use_native:
        from raytpu_torch.io import native

        if use_native or native.available():
            return native.load_obj(path)
    return load_obj_numpy(path)


def load_obj_numpy(path: str) -> Mesh:
    positions: List[Tuple[float, float, float]] = []
    vn_list: List[Tuple[float, float, float]] = []
    mtllib: dict = {}
    # faces as (vertex_index, normal_index-or-(-1)) pairs, fan-triangulated
    tri_v: List[Tuple[int, int, int]] = []
    tri_vn: List[Tuple[int, int, int]] = []

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                vn_list.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f":
                corners_v: List[int] = []
                corners_vn: List[int] = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = _resolve_index(int(fields[0]), len(positions))
                    ni = -1
                    if len(fields) >= 3 and fields[2]:
                        ni = _resolve_index(int(fields[2]), len(vn_list))
                    corners_v.append(vi)
                    corners_vn.append(ni)
                # fan triangulation for polygons (tinyobjloader default)
                for k in range(1, len(corners_v) - 1):
                    tri_v.append((corners_v[0], corners_v[k], corners_v[k + 1]))
                    tri_vn.append((corners_vn[0], corners_vn[k], corners_vn[k + 1]))
            elif tag == "mtllib" and len(parts) > 1:
                mtl_path = os.path.join(os.path.dirname(path), parts[1])
                mtllib.update(parse_mtl(mtl_path))
            # 'o', 'g', 'usemtl', 's', 'vt' — parsed past, like the
            # reference ignoring everything but vertex_index (src/main.cpp:1648)

    pos = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
    tris = np.asarray(tri_v, dtype=np.int32).reshape(-1, 3)
    vns = np.asarray(vn_list, dtype=np.float32).reshape(-1, 3)

    if tris.size and (tris.min() < 0 or tris.max() >= len(pos)):
        raise ValueError(
            f"{path}: face references vertex index "
            f"{int(tris.max()) + 1} but file declares only {len(pos)} vertices"
        )

    if len(vns) == len(pos):
        # position-aligned vn list: exact reference behavior
        normals = vns
    elif len(vns) > 0 and tri_vn and min(min(t) for t in tri_vn) >= 0:
        # resolve via explicit vn indices (last write wins per vertex)
        normals = np.zeros_like(pos)
        vn_idx = np.asarray(tri_vn, dtype=np.int64).reshape(-1)
        if vn_idx.size and vn_idx.max() >= len(vns):
            raise ValueError(
                f"{path}: face references normal index "
                f"{int(vn_idx.max()) + 1} but file declares only "
                f"{len(vns)} normals"
            )
        v_idx = tris.reshape(-1).astype(np.int64)
        normals[v_idx] = vns[vn_idx]
    else:
        normals = compute_smooth_normals(pos, tris)

    mesh = Mesh(
        positions=pos,
        normals=normals.astype(np.float32),
        triangles=tris,
        name=os.path.basename(path),
        materials_info=mtllib,
    )
    mesh.validate()
    return mesh
