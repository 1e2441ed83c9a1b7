"""Asset-free scenes for the PyTorch port.

Everything is generated from code and seeds and goes through the port's
``load_scene(cfg, meshes=..., skybox=...)``. A comparison with raytpu builds
raytpu's host ``Scene`` from the same config, meshes and sky and carries it
across with :func:`raytpu_torch.scene.scene_from_raytpu`. Every config keeps
the ``RenderConfig`` default ``wavefront="compact"``, so frames render
through the fused, compacted bounce loop.

* :func:`two_box_scene`: the two boxes of ``__graft_entry__.py:20-69``;
* :func:`mixed_scene`: mirror ``spin``, diffuse ``static`` and refractive
  ``orbit`` instances, so every material and sky misses occur;
* :func:`tie_scene`: two coincident boxes of different materials, where
  any difference in how two traversal tiers break exact ties shows;
* :func:`config4_standin` / :func:`reference_standin`: the shapes of the
  JAX presets ``config4`` and ``reference`` (``raytpu/presets.py:67,121``)
  without their files: ``generate_highpoly(depth=4)``, scaled to the
  teapot's extent, for ``teapot.obj``; ``armadillo_standin(depth=7)``
  (327,680 triangles) for the armadillo; a generated 6x1024x1024 sky for
  the sea skybox;
* :func:`config2_standin` / :func:`config3_standin`: the presets
  ``config2`` and ``config3`` (``raytpu/presets.py:38,51``), the mirror
  teapot stand-in alone, and :func:`cornell_mesh` (open walls and three
  boxes in one refractive mesh) for ``cube_scene.obj``, in front of the
  same sky. Both resolve to the consensus tier;
* :func:`config1_standin` / :func:`config5_standin`: the presets
  ``config1`` and ``config5`` (``raytpu/presets.py:24,88``): the diffuse
  cube (:func:`box_mesh`) alone and without a sky (consensus tier), and
  the mirror teapot stand-in with a refractive orbiting cube
  (:func:`cube_mesh`, flat faces as ``cube.obj`` has them) in front of
  the generated sky (per-lane tier).

``raytpu_torch.presets.STANDINS`` names the six stand-ins.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.config import MaterialType, ObjectConfig, RenderConfig
from raytpu_torch.io.genmesh import armadillo_standin, generate_highpoly
from raytpu_torch.io.obj import Mesh, compute_smooth_normals
from raytpu_torch.scene import Scene, load_scene

_BOX_FACES = np.array(
    [
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ],
    np.int32,
)

TEAPOT_RADIUS = 3.0  # teapot.obj spans about +-3 (raytpu/io/genmesh.py:101)


def box_mesh(center, half: float) -> Mesh:
    """Axis-aligned box, 12 triangles, smooth corner normals."""
    h = float(half)
    corners = np.array(
        [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)],
        np.float32,
    ) + np.asarray(center, np.float32)
    return Mesh(positions=corners,
                normals=compute_smooth_normals(corners, _BOX_FACES),
                triangles=_BOX_FACES.copy(), name="box")


def procedural_skybox(size: int, seed: int = 0) -> np.ndarray:
    """Seeded (6, size, size, 3) f32 cube map in [0, 1]: a per-face base
    color, smooth waves and noise, so that bilinear taps differ."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.15, 0.85, (6, 1, 1, 3)).astype(np.float32)
    phase = rng.uniform(0.0, 2.0 * np.pi, (6, 1, 1, 3)).astype(np.float32)
    g = np.linspace(0.0, 1.0, size, dtype=np.float32)
    wave = (np.sin(9.0 * g)[None, :, None, None]
            * np.cos(7.0 * g)[None, None, :, None])
    sky = np.empty((6, size, size, 3), np.float32)
    for f in range(6):  # per face keeps the temporaries at one face
        noise = rng.uniform(-0.05, 0.05, (size, size, 3)).astype(np.float32)
        sky[f] = base[f] + 0.1 * np.sin(wave[0] * 3.0 + phase[f]) + noise
    return np.clip(sky, 0.0, 1.0)


def two_box_scene(width=64, height=48, spp=1, bounces=3, **config) -> Scene:
    """Mirror spinning box + diffuse orbiting box, 4x4 sky ramp.
    ``config`` overrides RenderConfig fields."""
    cfg = RenderConfig(
        objects=(
            ObjectConfig("box0", MaterialType.MIRROR, "spin"),
            ObjectConfig("box1", MaterialType.DIFFUSE, "orbit"),
        ),
        width=width, height=height, samples_per_pixel=spp,
        max_bounce_count=bounces,
    ).replace(**config)
    sky = np.linspace(0.1, 0.9, 6 * 4 * 4 * 3, dtype=np.float32).reshape(
        6, 4, 4, 3)
    return load_scene(cfg, meshes=[box_mesh((0, 0, 0), 1.0),
                                   box_mesh((0, 0, 5), 0.7)], skybox=sky)


def mixed_scene(width=64, height=48, spp=1, bounces=3, depth=2,
                sky_size=16, **config) -> Scene:
    """Mirror ``spin`` highpoly sphere, diffuse ``static`` box and
    refractive ``orbit`` highpoly, in front of a generated sky: every
    material and sky misses occur. ``config`` overrides RenderConfig
    fields."""
    cfg = RenderConfig(
        objects=(
            ObjectConfig("sphere", MaterialType.MIRROR, "spin"),
            ObjectConfig("box", MaterialType.DIFFUSE, "static"),
            ObjectConfig("blob", MaterialType.REFRACTIVE, "orbit"),
        ),
        camera_position=(0.0, 1.0, 14.0),
        width=width, height=height, samples_per_pixel=spp,
        max_bounce_count=bounces,
    ).replace(**config)
    meshes = [
        generate_highpoly(depth=depth, radius=1.5, name="sphere"),
        box_mesh((3.0, -1.0, -2.0), 1.2),
        generate_highpoly(depth=depth, radius=2.0, name="blob"),
    ]
    return load_scene(cfg, meshes=meshes, skybox=procedural_skybox(sky_size))


def tie_scene(width=128, height=96, **config) -> Scene:
    """The JAX bench's tie-prone scene (``raytpu/bench.py:366``
    ``tie_scene_config``) without its files: two ``static`` instances of
    the same box at the identity, mirror and diffuse, so that every
    triangle is hit at exactly the same t through two entries, at spp 2
    and 2 bounces in front of the generated sky. Tiers that break the tie
    differently render different pixels. ``config`` overrides RenderConfig
    fields."""
    cfg = RenderConfig(
        objects=(
            ObjectConfig("box_a", MaterialType.MIRROR, "static"),
            ObjectConfig("box_b", MaterialType.DIFFUSE, "static"),
        ),
        width=width, height=height, samples_per_pixel=2, max_bounce_count=2,
    ).replace(**config)
    return load_scene(cfg, meshes=[box_mesh((0, 0, 0), 1.0),
                                   box_mesh((0, 0, 0), 1.0)],
                      skybox=procedural_skybox(16))


def _quad_mesh(quads, name: str) -> Mesh:
    """Quads (Q, 4, 3), corners in order around each face, as a mesh of 2Q
    triangles with flat normals (each quad has its own four vertices, as
    ``cube.obj`` duplicates its corners); the normal is the right-hand one
    of the corner order."""
    q = np.asarray(quads, np.float32)
    n = np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    base = 4 * np.arange(q.shape[0], dtype=np.int32)[:, None]
    tris = np.concatenate([base + [0, 1, 2], base + [0, 2, 3]], axis=1)
    return Mesh(positions=q.reshape(-1, 3), normals=np.repeat(n, 4, axis=0),
                triangles=tris.reshape(-1, 3), name=name)


def _box_quads(center, half, yaw: float = 0.0, inward: bool = False):
    """The six faces of a box (half extents ``half``) turned by ``yaw``
    radians about y, normals outward (or ``inward``)."""
    c, h = np.asarray(center, np.float64), np.asarray(half, np.float64)
    rot = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                    [-np.sin(yaw), 0.0, np.cos(yaw)]])
    quads = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3
        for sign in (1.0, -1.0):
            corners = []
            for cu, cv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[a], p[u], p[v] = sign * h[a], cu * h[u], cv * h[v]
                corners.append(p)
            if (sign < 0) != inward:   # corner order sets the normal
                corners.reverse()
            quads.append(c + np.asarray(corners) @ rot.T)
    return quads


def cornell_mesh() -> Mesh:
    """A Cornell-box-like scene as one mesh (``cube_scene.obj``: eight
    objects, 42 faces): five walls of a 12 x 10 x 12 room open toward the
    default camera, normals inward, and three boxes inside it, a tall and
    a short one turned about y and a cube above them; 23 quads, 46
    triangles. Seen from the default camera it fills the middle of the
    frame, and at 3 bounces some refracted paths end in total internal
    reflection."""
    room = _box_quads((0.0, 0.0, -4.0), (6.0, 5.0, 6.0), inward=True)
    del room[4]                                   # the +z face: open
    # the boxes stand sunk 0.2 into the floor: no face of theirs lies in a
    # wall's plane, where two triangles would tie at the same t
    boxes = (_box_quads((-2.2, -2.2, -6.0), (1.4, 3.0, 1.4), yaw=0.3)
             + _box_quads((2.4, -3.7, -2.5), (1.5, 1.5, 1.5), yaw=-0.3)
             + _box_quads((1.0, 2.2, -5.0), (0.9, 0.9, 0.9), yaw=0.6))
    return _quad_mesh(room + boxes, "cornell_standin")


def config2_standin(sky_size: int = 1024, **config) -> Scene:
    """config2's shape (``raytpu/presets.py:38``): the mirror teapot
    stand-in (``generate_highpoly(depth=4)`` at the teapot's extent, 5,120
    triangles; ``teapot.obj`` has 2,256), ``static``, in front of the
    generated 6x1024x1024 sky; 800x600, 4 spp, 2 bounces. ``sky_size`` and
    ``config`` (RenderConfig fields) cut it down for tests."""
    cfg = RenderConfig(
        objects=(ObjectConfig("generated://highpoly4", MaterialType.MIRROR,
                              "static"),),
        width=800, height=600, samples_per_pixel=4, max_bounce_count=2,
    ).replace(**config)
    return load_scene(cfg, meshes=[generate_highpoly(
        depth=4, radius=TEAPOT_RADIUS, name="teapot_standin")],
        skybox=procedural_skybox(sky_size))


def config3_standin(sky_size: int = 1024, **config) -> Scene:
    """config3's shape (``raytpu/presets.py:51``): :func:`cornell_mesh`,
    refractive and ``static``, in front of the generated sky; 1280x720,
    4 spp, 3 bounces. ``sky_size`` and ``config`` as for
    :func:`config2_standin`."""
    cfg = RenderConfig(
        objects=(ObjectConfig("generated://cornell", MaterialType.REFRACTIVE,
                              "static"),),
        width=1280, height=720, samples_per_pixel=4, max_bounce_count=3,
    ).replace(**config)
    return load_scene(cfg, meshes=[cornell_mesh()],
                      skybox=procedural_skybox(sky_size))


def config1_standin(**config) -> Scene:
    """config1's shape (``raytpu/presets.py:24``): one diffuse ``static``
    cube (:func:`box_mesh`, 12 triangles, for ``cube.obj``), no sky;
    512x512, 1 spp, 0 bounces (primary rays and hard shadows).
    ``traversal="auto"`` resolves it to the consensus tier. ``config``
    (RenderConfig fields) cuts it down for tests."""
    cfg = RenderConfig(
        objects=(ObjectConfig("generated://cube", MaterialType.DIFFUSE,
                              "static"),),
        skybox_dir=None, width=512, height=512, samples_per_pixel=1,
        max_bounce_count=0,
    ).replace(**config)
    return load_scene(cfg, meshes=[box_mesh((0.0, 0.0, 0.0), 1.0)])


def cube_mesh() -> Mesh:
    """``cube.obj``: the axis-aligned cube of half extent 1 about the
    origin, 24 vertices and 12 triangles, each face with its own four
    vertices and its flat outward normal (``cube.obj`` duplicates its
    corners for flat shading; a glass cube with :func:`box_mesh`'s
    averaged corner normals bends rays like a lens)."""
    return _quad_mesh(_box_quads((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), "cube")


def config5_standin(sky_size: int = 1024, **config) -> Scene:
    """config5's shape (``raytpu/presets.py:88``, the flythrough): the
    mirror teapot stand-in (``generate_highpoly(depth=4)``) ``spin`` and
    the refractive flat cube (:func:`cube_mesh`) ``orbit``, in front of the
    generated sky; 1920x1080, 1 spp, 3 bounces. ``traversal="auto"``
    resolves it to the per-lane tier (spp 1 with bounces). ``sky_size``
    and ``config`` as for :func:`config2_standin`."""
    cfg = RenderConfig(
        objects=(
            ObjectConfig("generated://highpoly4", MaterialType.MIRROR, "spin"),
            ObjectConfig("generated://cube", MaterialType.REFRACTIVE, "orbit"),
        ),
        width=1920, height=1080, samples_per_pixel=1, max_bounce_count=3,
    ).replace(**config)
    meshes = [generate_highpoly(depth=4, radius=TEAPOT_RADIUS,
                                name="teapot_standin"),
              cube_mesh()]
    return load_scene(cfg, meshes=meshes, skybox=procedural_skybox(sky_size))


def _standin(width, height, bounces, depth) -> Scene:
    cfg = RenderConfig(
        objects=(
            ObjectConfig("generated://highpoly4", MaterialType.MIRROR, "spin"),
            ObjectConfig("generated://armadillo", MaterialType.DIFFUSE, "orbit"),
        ),
        width=width, height=height, samples_per_pixel=4,
        max_bounce_count=bounces,
    )
    meshes = [generate_highpoly(depth=4, radius=TEAPOT_RADIUS, name="teapot_standin"),
              armadillo_standin(depth=depth)]
    return load_scene(cfg, meshes=meshes, skybox=procedural_skybox(1024))


def config4_standin(depth: int = 7) -> Scene:
    """config4's shape: 1920x1080, 4 spp, 3 bounces; ``depth`` is the
    armadillo stand-in's subdivision depth (7: 327,680 triangles)."""
    return _standin(1920, 1080, 3, depth)


def reference_standin(depth: int = 7) -> Scene:
    """The reference default's shape: 800x600, 4 spp, 63 bounces;
    ``depth`` as for :func:`config4_standin`."""
    return _standin(800, 600, 63, depth)
