"""Scene presets of the port (counterpart of ``raytpu/presets.py``): the
reference default and the five BASELINE benchmark configs, each a fully
specified :class:`RenderConfig` equal to raytpu's field by field, and
their asset-free stand-ins (:data:`STANDINS`, ``raytpu_torch/scenes.py``).

The presets read their meshes and skyboxes from ``REFERENCE_RESOURCES``
(or a ``resource_dir``). Where a file is missing, :func:`load_preset_scene`
raises :class:`~raytpu_torch.utils.log.RaytpuError` naming it; it never
swaps a stand-in in. The stand-ins are the presets' shapes made from code
and seeds, resolved by the names ``config1_standin`` ...
``config5_standin`` and ``reference_standin``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from raytpu_torch import scenes
from raytpu_torch.config import MaterialType, ObjectConfig, RenderConfig
from raytpu_torch.io.genmesh import armadillo_standin
from raytpu_torch.io.image import SKYBOX_FACE_FILES
from raytpu_torch.io.obj import Mesh, load_obj
from raytpu_torch.scene import Scene, load_scene
from raytpu_torch.utils import log

REFERENCE_RESOURCES = "/root/reference/resources"


def _res(resource_dir: Optional[str]) -> str:
    return resource_dir or REFERENCE_RESOURCES


def config1_cube(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 1: cube.obj, primary rays + hard shadows, static
    camera, 512x512."""
    r = _res(resource_dir)
    return RenderConfig(
        objects=(ObjectConfig(f"{r}/cube.obj", MaterialType.DIFFUSE, "static"),),
        skybox_dir=None,
        width=512,
        height=512,
        samples_per_pixel=1,
        max_bounce_count=0,  # primary + shadow only
    )


def config2_teapot_mirror(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 2: teapot mirror + sea skybox, 2-bounce, 800x600."""
    r = _res(resource_dir)
    return RenderConfig(
        objects=(ObjectConfig(f"{r}/teapot.obj", MaterialType.MIRROR, "static"),),
        skybox_dir=f"{r}/skybox_texture_sea",
        width=800,
        height=600,
        samples_per_pixel=4,
        max_bounce_count=2,
    )


def config3_refract(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 3: cube_scene.obj refractive glass (Snell + TIR),
    3-bounce, 1280x720."""
    r = _res(resource_dir)
    return RenderConfig(
        objects=(
            ObjectConfig(f"{r}/cube_scene.obj", MaterialType.REFRACTIVE, "static"),
        ),
        skybox_dir=f"{r}/skybox_texture_sea",
        width=1280,
        height=720,
        samples_per_pixel=4,
        max_bounce_count=3,
    )


def config4_highpoly(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 4: mirror teapot ``spin`` and the generated
    armadillo stand-in ``orbit`` (``armadillo.obj`` is not shipped),
    3-bounce, 1920x1080."""
    r = _res(resource_dir)
    return RenderConfig(
        objects=(
            ObjectConfig(f"{r}/teapot.obj", MaterialType.MIRROR, "spin"),
            ObjectConfig("generated://armadillo", MaterialType.DIFFUSE, "orbit"),
        ),
        skybox_dir=f"{r}/skybox_texture_sea",
        width=1920,
        height=1080,
        samples_per_pixel=4,
        max_bounce_count=3,
    )


def config5_flythrough(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 5: interactive flythrough, mirror teapot ``spin`` and
    refractive cube ``orbit``, per-frame re-trace, 1920x1080."""
    r = _res(resource_dir)
    return RenderConfig(
        objects=(
            ObjectConfig(f"{r}/teapot.obj", MaterialType.MIRROR, "spin"),
            ObjectConfig(f"{r}/cube.obj", MaterialType.REFRACTIVE, "orbit"),
        ),
        skybox_dir=f"{r}/skybox_texture_sea",
        width=1920,
        height=1080,
        samples_per_pixel=1,
        max_bounce_count=3,
    )


def reference_scene(resource_dir: Optional[str] = None) -> RenderConfig:
    """The reference's shipped compile-time default (``include/config.h``):
    mirror teapot center + diffuse armadillo stand-in orbiting, sea skybox,
    800x600, 4 spp, 63 bounces."""
    r = _res(resource_dir)
    return RenderConfig(
        objects=(
            ObjectConfig(f"{r}/teapot.obj", MaterialType.MIRROR, "spin"),
            ObjectConfig("generated://armadillo", MaterialType.DIFFUSE, "orbit"),
        ),
        skybox_dir=f"{r}/skybox_texture_sea",
        width=800,
        height=600,
        samples_per_pixel=4,
        max_bounce_count=63,
    )


PRESETS: Dict[str, Callable[..., RenderConfig]] = {
    "config1": config1_cube,
    "config2": config2_teapot_mirror,
    "config3": config3_refract,
    "config4": config4_highpoly,
    "config5": config5_flythrough,
    "reference": reference_scene,
}

# name -> scene of the preset's shape from code and seeds; the argument is
# the armadillo stand-in's subdivision depth, which config4 and the
# reference default carry
STANDINS: Dict[str, Callable[[int], Scene]] = {
    "config1_standin": lambda depth: scenes.config1_standin(),
    "config2_standin": lambda depth: scenes.config2_standin(),
    "config3_standin": lambda depth: scenes.config3_standin(),
    "config4_standin": lambda depth: scenes.config4_standin(depth=depth),
    "config5_standin": lambda depth: scenes.config5_standin(),
    "reference_standin": lambda depth: scenes.reference_standin(depth=depth),
}


def _require_file(path: str, what: str) -> None:
    if not os.path.isfile(path):
        log.fail(f"{what}: missing file {path} (the asset-free stand-ins are "
                 f"{sorted(STANDINS)})")


def load_preset_scene(preset, highpoly_depth: int = 7) -> Scene:
    """A loaded :class:`Scene` of ``preset``: a name of :data:`PRESETS` or
    :data:`STANDINS`, a :class:`RenderConfig`, or a loaded Scene (returned
    as it is). ``generated://`` meshes become the armadillo stand-in at
    ``highpoly_depth``; every other mesh and the skybox are read from their
    files, and a missing file raises ``RaytpuError`` naming it."""
    if isinstance(preset, Scene):
        return preset
    if isinstance(preset, str):
        if preset in STANDINS:
            return STANDINS[preset](highpoly_depth)
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; available: "
                           f"{sorted(PRESETS) + sorted(STANDINS)}")
        config = PRESETS[preset]()
    else:
        config = preset

    meshes: List[Mesh] = []
    for obj in config.objects:
        if obj.path.startswith("generated://"):
            meshes.append(armadillo_standin(depth=highpoly_depth))
        else:
            _require_file(obj.path, "mesh")
            meshes.append(load_obj(obj.path))
    if config.skybox_dir is not None:
        for name in SKYBOX_FACE_FILES:
            _require_file(os.path.join(config.skybox_dir, name), "skybox face")
    return load_scene(config, meshes=meshes)
