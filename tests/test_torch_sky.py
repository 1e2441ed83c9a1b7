"""Plain sky sampler of the PyTorch port against
``raytpu.ops.sky.sample_cubemap_u32`` (the function of the TPU's MXU sky
kernel), on a seeded 6x16x16 map with axis-aligned, face-edge, corner and
random directions."""

import jax.numpy as jnp
import numpy as np
import torch

from raytpu.ops import sky as jsky
from raytpu_torch.device_scene import pack_skybox
from raytpu_torch.ops import sky


def _directions():
    rng = np.random.default_rng(11)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    # face edges and corners: two or three equal-magnitude components
    signs = np.array([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                      for c in (-1, 1)], np.float64)
    edges = np.concatenate([signs * m for m in
                            ([1, 1, 0], [1, 0, 1], [0, 1, 1])])
    near = signs * np.array([1.0, 1.0 - 1e-7, 0.3])
    rand = rng.normal(size=(4000, 3))
    d = np.concatenate([axes, signs, edges, near, rand, 1e3 * rand[:50]])
    return d.astype(np.float32)


def test_sample_cubemap_matches_jax():
    rng = np.random.default_rng(3)
    sky_f = rng.uniform(0, 1, (6, 16, 16, 3)).astype(np.float32)
    words, (h, w) = pack_skybox(sky_f)
    d = _directions()

    want = jsky.sample_cubemap_u32(
        jnp.asarray(words.view(np.uint32)), h, w,
        tuple(jnp.asarray(d[:, c]) for c in range(3)))
    got = sky.sample_cubemap_u32_ref(
        torch.from_numpy(words), h, w,
        tuple(torch.from_numpy(d[:, c].copy()) for c in range(3)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=1e-6)

    jf, js, jt = jsky.face_st(*(jnp.asarray(d[:, c]) for c in range(3)))
    tf, ts_, tt = sky.face_st(*(torch.from_numpy(d[:, c].copy()) for c in range(3)))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
