"""The port's presets against raytpu's, and its asset-free stand-ins.

Every ``PRESETS`` config equals raytpu's field by field. Each stand-in has
its preset's shape (resolution, spp, bounces, materials, animations, sky
or none) and resolves by name; a preset whose files are missing raises
``RaytpuError`` naming the file, never a stand-in. The two new stand-ins,
config1 (a diffuse cube without sky, 0 bounces) and config5 (a mirror
teapot stand-in ``spin`` and a refractive cube ``orbit``, spp 1, 3
bounces), are held against raytpu at 64x48 from the same primary rays
(1e-5 per pixel, both frames rendered without fused multiply-adds) and by
SSIM > 0.98, and ``auto`` resolves them to the consensus and
the per-lane tier as raytpu's table does.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytpu import presets as jpresets
from raytpu.accel import resolve_auto_tier as jax_resolve_auto_tier
from raytpu.utils.ssim import ssim
from raytpu_torch import presets, scenes
from raytpu_torch.accel import resolve_auto_tier
from raytpu_torch.utils.log import RaytpuError
from tests.test_torch_frame import _same_rays_frames

NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent


# raytpu's RenderConfig fields the port does not take: its TPU scheduling
# knobs and the fields that change nothing in the port
NOT_PORTED = {"divergence", "bounce_unroll", "sky_sampler", "sky_rebin", "dtype"}


def _fields(cfg, names=None) -> dict:
    names = names or [f.name for f in dataclasses.fields(cfg)]
    out = {name: getattr(cfg, name) for name in names}
    out["objects"] = tuple((o.path, int(o.material), o.animation)
                           for o in cfg.objects)
    return out


def test_preset_names_equal_raytpus():
    assert list(presets.PRESETS) == list(jpresets.PRESETS)


@pytest.mark.parametrize("name", list(jpresets.PRESETS))
def test_preset_equals_raytpu_field_by_field(name):
    """Every field of the port's preset equals raytpu's; raytpu's other
    fields are those the port does not take, each at its default."""
    for resource_dir in (None, "/elsewhere"):
        got = _fields(presets.PRESETS[name](resource_dir))
        jcfg = jpresets.PRESETS[name](resource_dir)
        assert got == _fields(jcfg, list(got))
        rest = {f.name: f.default for f in dataclasses.fields(jcfg)}
        rest = {k: v for k, v in rest.items() if k not in got}
        assert set(rest) == NOT_PORTED
        assert all(getattr(jcfg, k) == v for k, v in rest.items())


@pytest.mark.parametrize("name", list(jpresets.PRESETS))
def test_standin_has_its_presets_shape(name):
    scene = presets.load_preset_scene(f"{name}_standin", highpoly_depth=2)
    cfg, want = scene.config, jpresets.PRESETS[name]()
    for f in ("width", "height", "samples_per_pixel", "max_bounce_count",
              "traversal", "wavefront"):
        assert getattr(cfg, f) == getattr(want, f), f
    assert [(int(o.material), o.animation) for o in cfg.objects] == \
        [(int(o.material), o.animation) for o in want.objects]
    assert (scene.skybox is None) == (want.skybox_dir is None)
    assert len(scene.meshes) == len(want.objects)


def test_missing_asset_raises_naming_the_file(tmp_path, monkeypatch):
    monkeypatch.setattr(presets, "REFERENCE_RESOURCES", str(tmp_path / "none"))
    with pytest.raises(RaytpuError, match="none/teapot.obj"):
        presets.load_preset_scene("config2")
    cube = tmp_path / "cube.obj"
    cube.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    # config1 has no sky: its one mesh is all it reads
    assert presets.load_preset_scene(presets.config1_cube(str(tmp_path))) \
        .geometry.num_meshes == 1
    with pytest.raises(RaytpuError, match="skybox_texture_sea/right.jpg"):
        presets.load_preset_scene(presets.config5_flythrough(str(tmp_path)).replace(
            objects=presets.config1_cube(str(tmp_path)).objects))
    with pytest.raises(KeyError, match="config9"):
        presets.load_preset_scene("config9")


# the new stand-ins at 64x48 as _same_rays_frames renders them: (scene of
# width, height, spp, bounces; the tier "auto" resolves it to; spp; bounces)
NEW_STANDINS = {
    "config1": (lambda w, h, spp, b: scenes.config1_standin(width=w, height=h),
                "mega", 1, 0),
    "config5": (lambda w, h, spp, b: scenes.config5_standin(
        sky_size=64, width=w, height=h), "perlane", 1, 3),
}


@pytest.fixture(scope="module")
def new_standin_frames(tmp_path_factory):
    """(port frame, raytpu frame) of each new stand-in from the same
    primary rays, rendered in a child process whose XLA:CPU has no fused
    multiply-add (``--xla_cpu_max_isa=AVX``, as in
    ``test_torch_consensus.py``): with FMA, config5's refracting cube
    amplifies the chain's other rounding to 1.3e-4 on 17 of 9,216 values."""
    out = tmp_path_factory.mktemp("standins") / "frames.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name", list(NEW_STANDINS))
def test_new_standin_matches_raytpu(name, new_standin_frames):
    make, tier, spp, bounces = NEW_STANDINS[name]
    tris = make(64, 48, spp, bounces).geometry.triangles.shape[0]
    assert resolve_auto_tier(tris, spp, bounces) == tier
    assert jax_resolve_auto_tier(tris, spp, bounces) == tier
    got, want = new_standin_frames[f"{name}_got"], new_standin_frames[f"{name}_want"]
    assert got.shape == want.shape == (48, 64, 3)
    assert want.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ssim(got, want) > 0.98


if __name__ == "__main__":
    # both stand-ins' frames, in a process whose XLA_FLAGS the parent set;
    # _same_rays_frames asserts the port's frame took the stand-in's tier
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    frames = {}
    for name, (make, tier, spp, bounces) in NEW_STANDINS.items():
        frames[f"{name}_got"], frames[f"{name}_want"] = _same_rays_frames(
            64, 48, spp, bounces, scene_fn=make, tier=tier)
    np.savez(sys.argv[1], **frames)
