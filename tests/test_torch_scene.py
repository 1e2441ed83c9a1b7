"""Device scene and BVH attachment of the PyTorch port against raytpu's.

* ``from_raytpu`` carries a raytpu scene across field for field, including
  the chunked ``bvh_*`` arrays and the entry table of ``traversal_list``;
* the port's own build (no chunks) agrees with raytpu's on every non-BVH
  field, and its native trees pass ``raytpu.accel.bvh.validate_bvh``;
* ``with_transforms`` follows ``AnimationState``;
* ``scene_from_raytpu`` hands the port raytpu's host scene, array for array.
"""

import dataclasses

import numpy as np
import pytest

from raytpu.accel.bvh import validate_bvh
from raytpu.render import Renderer as JaxRenderer
from raytpu.scene import AnimationState
from raytpu_torch import scenes
from raytpu_torch.accel import Bvh
from raytpu_torch.device_scene import build_device_scene, corner_tables, from_raytpu
from raytpu_torch.render import Renderer
from raytpu_torch.scene import scene_from_raytpu
from tests.torch_twin import one_thread, raytpu_twin, twin


@pytest.fixture(scope="module")
def chunked():
    jscene, scene = twin(scenes.mixed_scene(32, 32, 1, 1, depth=2, chunk_tris=256))
    jr = JaxRenderer(jscene)
    jr.set_transforms(0.1)
    return scene, jr


def _np(t):
    return t.cpu().numpy()


def test_from_raytpu_reproduces_every_field(chunked):
    scene, jr = chunked
    dev, static = jr.device_scene, jr.static
    assert len(static.traversal_list) > len(static.instance_mesh)  # chunked
    ts = from_raytpu(dev, static, "cpu")
    for name in ("o2w", "w2o", "materials", "light_pos", "light_intensity",
                 "tri_n_soa", "bvh_aabb_min", "bvh_aabb_max", "bvh_tri_first",
                 "bvh_tri_count", "bvh_miss", "bvh_tri_v0", "bvh_tri_e1",
                 "bvh_tri_e2", "bvh_tri_prim", "bvh_tri_n_soa"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(dev, name)), name)
    np.testing.assert_array_equal(_np(ts.skybox_u32).view(np.uint32),
                                  np.asarray(dev.skybox_u32))
    assert ts.sky_hw == tuple(static.sky_hw)
    assert ts.traversal_list == tuple(static.traversal_list)
    want = [
        (inst, int(np.asarray(dev.materials)[inst]),
         *static.mesh_node_ranges[mesh], static.mesh_bvh_tri_ranges[mesh][0])
        for inst, mesh in static.traversal_list
    ]
    assert _np(ts.entries).tolist() == [list(w) for w in want]


def test_own_build_matches_raytpu_fields(chunked):
    scene, jr = chunked
    ts = build_device_scene(scene, "cpu")
    dev = jr.device_scene
    anim = scene.animation()
    np.testing.assert_array_equal(_np(ts.o2w), anim.transforms_3x4())
    np.testing.assert_array_equal(_np(ts.w2o), anim.inverse_transforms_3x4())
    for name in ("materials", "light_pos", "light_intensity", "tri_n_soa"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(dev, name)), name)
    np.testing.assert_array_equal(_np(ts.skybox_u32).view(np.uint32),
                                  np.asarray(dev.skybox_u32))
    assert ts.sky_hw == tuple(jr.static.sky_hw)


def test_attach_bvh_native_trees_validate():
    scene = scenes.mixed_scene(32, 32, 1, 1, depth=3)
    ts = Renderer(scene, "cpu").tscene
    v0, e1, e2, _ = corner_tables(scene)
    assert len(ts.traversal_list) == len(scene.instances)
    entries = _np(ts.entries)
    for inst, mesh in ts.traversal_list:
        _, mat, nb, nc, tb = entries[inst]
        assert mat == int(scene.instances[inst].material)
        _, ps = scene.geometry.mesh_slice(mesh)
        nt = ps.stop - ps.start
        bvh = Bvh(
            aabb_min=_np(ts.bvh_aabb_min)[nb:nb + nc],
            aabb_max=_np(ts.bvh_aabb_max)[nb:nb + nc],
            tri_first=_np(ts.bvh_tri_first)[nb:nb + nc],
            tri_count=_np(ts.bvh_tri_count)[nb:nb + nc],
            miss=_np(ts.bvh_miss)[nb:nb + nc],
            tri_order=_np(ts.bvh_tri_prim)[tb:tb + nt] - ps.start,
        )
        validate_bvh(bvh, v0[ps], e1[ps], e2[ps])
        # leaf-ordered corners are the mesh's corners permuted
        np.testing.assert_array_equal(_np(ts.bvh_tri_v0)[tb:tb + nt],
                                      v0[ps][bvh.tri_order])
    assert ts.leaf_max <= scene.config.leaf_size


def test_with_transforms_follows_animation():
    jscene, scene = twin(scenes.mixed_scene(32, 32, 1, 1, depth=1))
    r = Renderer(scene, "cpu")
    anim = AnimationState(jscene.instances)
    for t in (0.25, 1.5):  # spin accumulates: both steps must agree
        r.set_transforms(t)
        anim.step(t)
        np.testing.assert_array_equal(_np(r.tscene.o2w), anim.transforms_3x4())
        np.testing.assert_array_equal(_np(r.tscene.w2o),
                                      anim.inverse_transforms_3x4())


def test_scene_from_raytpu_carries_every_array():
    """The port's Scene of a raytpu Scene holds the same arrays, instances
    and config, and renders the port's own scene's frame exactly."""
    own = scenes.two_box_scene(32, 32, 1, 2)
    jscene = raytpu_twin(own)
    scene = scene_from_raytpu(jscene)
    g, jg = scene.geometry, jscene.geometry
    for name in ("positions", "normals", "triangles"):
        assert getattr(g, name) is getattr(jg, name)
    assert (g.vertex_offsets, g.primitive_offsets, g.mesh_names) == (
        jg.vertex_offsets, jg.primitive_offsets, jg.mesh_names)
    assert scene.skybox is jscene.skybox
    for m, jm in zip(scene.meshes, jscene.meshes):
        assert m.positions is jm.positions and m.triangles is jm.triangles
    for i, ji in zip(scene.instances, jscene.instances):
        assert (i.mesh_id, int(i.material), i.animation) == (
            ji.mesh_id, int(ji.material), ji.animation)
        np.testing.assert_array_equal(i.transform, ji.transform)
    for f in dataclasses.fields(scene.config):
        if f.name != "objects":
            assert getattr(scene.config, f.name) == getattr(jscene.config, f.name)
    assert [(o.path, int(o.material), o.animation) for o in scene.config.objects] == [
        (o.path, int(o.material), o.animation) for o in jscene.config.objects]
    with one_thread():
        np.testing.assert_array_equal(Renderer(scene, "cpu").render_np(),
                                      Renderer(own, "cpu").render_np())
