"""Plain raygen of the PyTorch port against the JAX raygens: the Pallas
kernel ``raytpu.ops.raygen.raygen_packed`` (interpret mode) and the XLA
``primary_rays_soa``. The contract is that of ``tests/test_raygen.py``:
the shader hash is chaotic in its last argument bit, so origins are exact,
directions unit length within 1e-5, and within 2.5/H of the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.integrator import primary_rays_soa
from raytpu.ops import raygen as jraygen
from raytpu.ops.traverse_pallas import PACKET_K, pack_rays
from raytpu_torch.ops import raygen

W, H = 800, 600


def _check(got, want):
    np.testing.assert_array_equal(got[:3], want[:3])
    n2 = (got[3] ** 2 + got[4] ** 2 + got[5] ** 2).ravel()
    np.testing.assert_allclose(n2, 1.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3:], want[3:], rtol=0, atol=2.5 / H)


@pytest.mark.parametrize("spp", [1, 4])
def test_raygen_ref_matches_jax(spp):
    p, k = jraygen.RG_BP * 2, PACKET_K
    rng = np.random.RandomState(17)
    px = rng.randint(0, W, size=(p, k)).astype(np.float32)
    py = rng.randint(0, H, size=(p, k)).astype(np.float32)
    cam = np.asarray([[0.25, -1.5, 5.0], [0.8, 0.0, 0.6], [0.0, 1.0, 0.0],
                      [-0.6, 0.0, 0.8]], np.float32)
    s_row = rng.randint(0, spp, size=(p,)).astype(np.float32)

    got = raygen.raygen_packed_ref(
        torch.from_numpy(cam), torch.from_numpy(s_row), torch.from_numpy(px),
        torch.from_numpy(py), spp, W, H).numpy()

    kernel = np.asarray(jraygen.raygen_packed(
        jnp.asarray(cam), jnp.asarray(s_row), jnp.asarray(px),
        jnp.asarray(py), spp, W, H)).reshape(6, p, k)
    _check(got, kernel)

    s_idx = jnp.asarray(s_row)[:, None] * jnp.ones((1, k), jnp.float32)
    o, d = primary_rays_soa((jnp.asarray(px), jnp.asarray(py)),
                            jnp.asarray(cam), s_idx, spp, W, H)
    xla = np.asarray(pack_rays(o, d)).reshape(6, p, k)
    _check(got, xla)


def _rays_with_hash(jitter_fn, monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(raygen, "hash_jitter", jitter_fn)
        return raygen.raygen_packed_ref(*args)


def _sloppy_sine(px, py, sample_idx, spp):
    """The hash with a sine good to 1e-6, as a fast-math sine is at the
    1080p arguments (~1e5)."""
    seed0 = float(spp) + sample_idx.to(torch.float32)

    def rnd(seed):
        arg = px * 12.9898 + py * 78.233 + 1113.1 * seed
        x = (torch.sin(arg) + 1e-6) * 43758.5453
        return x - torch.floor(x)

    return rnd(seed0), rnd(seed0 + 0.5)


@pytest.mark.parametrize("variant", ["hash", "seed", "spp", "no_hash", "sloppy_sine"])
def test_jitter_error_tells_the_hash(variant, monkeypatch):
    """``jitter_error`` (the card's tight raygen check) passes the shader
    hash at 1920x1080 and fails a raygen with another seed, spp, no hash or
    an imprecise sine."""
    w, h, spp = 1920, 1080, 4
    rng = np.random.RandomState(5)
    p, k = 16, PACKET_K
    px = torch.from_numpy(rng.randint(0, w, size=(p, k)).astype(np.float32))
    py = torch.from_numpy(rng.randint(0, h, size=(p, k)).astype(np.float32))
    s_row = torch.from_numpy(rng.randint(0, spp, size=(p,)).astype(np.float32))
    cam = torch.tensor([[0.0, 1.0, 14.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [0.0, 0.0, -1.0]])
    args = (cam, s_row, px, py, spp, w, h)
    rays = {
        "hash": lambda: raygen.raygen_packed_ref(*args),
        "seed": lambda: raygen.raygen_packed_ref(cam, s_row + 1, px, py, spp, w, h),
        "spp": lambda: raygen.raygen_packed_ref(cam, s_row, px, py, spp + 1, w, h),
        "no_hash": lambda: _rays_with_hash(
            lambda px, *_: (torch.full_like(px, 0.5),) * 2, monkeypatch, *args),
        "sloppy_sine": lambda: _rays_with_hash(_sloppy_sine, monkeypatch, *args),
    }[variant]()
    err = raygen.jitter_error(rays, *args)
    if variant == "hash":
        assert err <= raygen.JITTER_TOL, err
    else:
        assert err > 100 * raygen.JITTER_TOL, err
