"""Helpers of the port's comparison tests.

``raytpu_twin(scene)`` builds raytpu's ``Scene`` with ``raytpu.load_scene``
from a port scene's config, meshes and sky; ``twin(scene)`` also carries
that scene back across with ``raytpu_torch.scene.scene_from_raytpu``, so
both packages render the very same numpy arrays. ``one_thread()`` runs a
block of eager CPU frames on one PyTorch thread.
"""

import contextlib
import dataclasses

import torch

from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.io.obj import Mesh
from raytpu.scene import load_scene
from raytpu_torch.scene import scene_from_raytpu


def _fields(obj, cls) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def raytpu_twin(scene):
    """raytpu's host Scene of the port scene ``scene``."""
    cfg = scene.config
    objects = tuple(
        ObjectConfig(o.path, MaterialType(int(o.material)), o.animation)
        for o in cfg.objects
    )
    config = RenderConfig(**{**_fields(cfg, RenderConfig), "objects": objects})
    return load_scene(config, meshes=[Mesh(**_fields(m, Mesh)) for m in scene.meshes],
                      skybox=scene.skybox)


def twin(scene):
    """(raytpu Scene, port Scene) holding the same arrays."""
    jscene = raytpu_twin(scene)
    return jscene, scene_from_raytpu(jscene)


@contextlib.contextmanager
def one_thread():
    """One intra-op thread for the block: the plain walks are thousands of
    small ops, which gain little from threads, and several test workers'
    thread pools on one machine's cores slow each other down many times
    over (a 4 s frame took 170 s under four such workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
