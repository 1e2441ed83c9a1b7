"""Helpers of the port's comparison tests.

``raytpu_twin(scene)`` builds raytpu's ``Scene`` with ``raytpu.load_scene``
from a port scene's config, meshes and sky; ``twin(scene)`` also carries
that scene back across with ``raytpu_torch.scene.scene_from_raytpu``, so
both packages render the very same numpy arrays. ``one_thread()`` runs a
block of eager CPU frames on one PyTorch thread. ``cone_rays`` makes seeded
waves of whole culling blocks for the per-lane tier's tests.
"""

import contextlib
import dataclasses

import numpy as np
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
    # the port's fields, each of which raytpu's RenderConfig has too
    config = RenderConfig(**{**_fields(cfg, type(cfg)), "objects": objects})
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


def cone_rays(n_blocks: int, seed: int, k: int = 1024):
    """Seeded (6, P, k) f32 rays and (P, k) window, P = 8 * ``n_blocks``:
    one cone of rays per block of 8 packets, aimed at the scene's centre
    from outside it, so that blocks hit different entries; every third
    block points away, block 5 (if any) is dead, every fifth lane is dead
    and every fourth block has a short window (9)."""
    rng = np.random.default_rng(seed)
    lanes = 8 * k
    o, d = [], []
    for b in range(n_blocks):
        u = rng.normal(size=3)
        centre = u / np.linalg.norm(u) * rng.uniform(8.0, 14.0)
        ob = centre + rng.normal(scale=0.3, size=(lanes, 3))
        target = rng.uniform(-2.0, 2.0, 3) + rng.normal(scale=1.5, size=(lanes, 3))
        db = target - ob
        if b % 3 == 2:
            db = -db
        o.append(ob)
        d.append(db / np.linalg.norm(db, axis=1, keepdims=True))
    o, d = np.concatenate(o), np.concatenate(d)
    p = n_blocks * 8
    rays = np.concatenate([o.T, d.T]).astype(np.float32).reshape(6, p, k)
    win = np.full((p, k), 1e4, np.float32)
    win.reshape(-1)[::5] = 0.0
    win[5 * 8:6 * 8] = 0.0
    for b in range(0, n_blocks, 4):
        win[b * 8:(b + 1) * 8] = np.minimum(win[b * 8:(b + 1) * 8], 9.0)
    return rays, win
