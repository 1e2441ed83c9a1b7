"""``integrator.render_pixels`` of the PyTorch port (``raytpu/integrator.py:976``)
on the CPU, with the kernels' plain versions: a list of pixels in packets
of ``min(1024, R)`` lanes against the port's own frame at those pixels,
and the whole frame's pixels against raytpu's ``render_pixels`` of the
same scene (``tests/torch_twin.py``).

The whole frame's 3,072 pixels in row order are 3 packets of 1,024 lanes,
which take the frame's tier and its fused loop, so they equal the frame bit
for bit. A list of 500 pixels is one packet of 500 lanes, which every tier
renders through the XLA body on the per-(instance, mesh) loop (as raytpu
routes packets other than 1,024 lanes), so those pixels equal the frame
rendered through that body (``traversal="xla"``) bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.integrator import render_pixels as jax_render_pixels
from raytpu.render import Renderer as JaxRenderer
from raytpu.utils.ssim import ssim
from raytpu_torch import scenes
from raytpu_torch.integrator import render_frame, render_pixels
from raytpu_torch.render import Renderer
from tests.torch_twin import one_thread, twin

T_ANIM = 0.25
W, H = 64, 48


@pytest.fixture(scope="module")
def frames():
    """Both packages' Renderers of the twin scene, posed; the port's frame
    and the frame's pixels in row order, (R, 2) f32."""
    jscene, scene = twin(scenes.mixed_scene(W, H, spp=2, bounces=3))
    r, jr = Renderer(scene, "cpu"), JaxRenderer(jscene)
    for x in (r, jr):
        x.set_transforms(T_ANIM)
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)
    with one_thread():
        img = render_frame(r.tscene, r.render_static, r.camera_tensor())
    return r, jr, img, pix


def test_frame_pixels_equal_the_frame(frames):
    r, _, img, pix = frames
    stats = {}
    with one_thread():
        got = render_pixels(r.tscene, r.render_static, r.camera_tensor(),
                            torch.from_numpy(pix), stats=stats)
    assert got.shape == (W * H, 3) and stats["tier"] == "mega"
    assert torch.equal(got.reshape(H, W, 3), img)


def test_a_short_list_takes_the_body(frames):
    r, _, _, pix = frames
    sel = np.random.default_rng(3).permutation(W * H)[:500]
    stats = {}
    with one_thread():
        got = render_pixels(r.tscene, r.render_static, r.camera_tensor(),
                            torch.from_numpy(pix[sel]), stats=stats)
        body = render_frame(dataclasses.replace(r.tscene, traversal="xla"),
                            r.render_static, r.camera_tensor())
    assert got.shape == (500, 3) and stats["tier"] == "xla"
    assert torch.equal(got, body.reshape(-1, 3)[torch.from_numpy(sel)])


def test_frame_pixels_against_raytpu(frames):
    """The same-scene bar of ``test_torch_frame.test_renderer_frame_ssim_
    against_raytpu``: SSIM > 0.98."""
    r, jr, _, pix = frames
    fn = jax.jit(jax_render_pixels, static_argnums=(1, 2))
    want = np.asarray(fn(jr.device_scene, jr.static, jr.render_static,
                         jnp.asarray(jr.camera.basis()), jnp.asarray(pix)))
    with one_thread():
        got = render_pixels(r.tscene, r.render_static, r.camera_tensor(),
                            torch.from_numpy(pix)).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert ssim(got.reshape(H, W, 3), want.reshape(H, W, 3)) > 0.98
