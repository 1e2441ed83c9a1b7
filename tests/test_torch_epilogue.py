"""The fused bounce loop of the PyTorch port against raytpu's.

* The plain shade and accumulate passes (``shade_epilogue_ref``,
  ``accumulate_epilogue_ref``) against raytpu's Pallas kernels K3 and K4
  (``raytpu.ops.epilogue``, interpret mode) on 32 seeded packets with dead
  lanes, misses, all three materials, backfaces and TIR lanes: integer
  outputs exact, floats within 2e-6 (the bar of ``tests/test_epilogue.py``).
  The JAX side runs in a child process with ``--xla_cpu_max_isa=AVX``, as in
  ``test_torch_traverse.py``: without FMA instructions XLA:CPU rounds every
  operation once, as the port does, and every output but ``ndoth**100``
  agrees bit for bit (measured); the power differs by at most 6e-8, one ulp
  of the two libraries' ``pow``. With FMA contraction allowed, the shadow
  origins of the miss lanes (t = 1e4) drift by 1e-3 and ``ndoth**100`` by
  2e-5, since the exponent multiplies a one-ulp change of ``ndoth`` by up
  to 100.
* The wave budget and the rung ladder equal raytpu's for every P the JAX
  package's own test checks.
* The compacted frame equals the full-width fused frame bit for bit at
  512x130, spp 1 (P = 128, budget 64), with the rung table as it is and
  patched to ``[budget, 16]``, and across a phase transition of the ladder.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu import integrator as ji
from raytpu_torch import integrator, scenes
from raytpu_torch.integrator import render_frame
from raytpu_torch.ops import epilogue
from raytpu_torch.render import Renderer
from tests.torch_twin import one_thread

P, K = 32, 1024
LIGHT_POS = (5.0, 5.0, 5.0)
LIGHT_INTENSITY = 1.0
NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent
SHADE_OUT = ("srays", "swin", "ab", "lit", "nrays", "nwin", "miss")


def _shade_inputs():
    """rays (6, P, K), post-sweep state (9, P, K), miss (P, K) int32: every
    fifth lane and packet 7 dead (t = 0, some with a miss recorded), live
    lanes hit (t in [0.2, 4]) or missed (t = 1e4, valid 0), materials 0-2,
    normals of random length and direction (backfaces, TIR)."""
    rng = np.random.default_rng(11)
    n = P * K
    o = rng.uniform(-3, 3, (3, n))
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    rays = np.concatenate([o, d]).astype(np.float32).reshape(6, P, K)
    dead = np.zeros(n, bool)
    dead[::5] = True
    dead[7 * K:8 * K] = True
    valid = (rng.uniform(size=n) < 0.75) & ~dead
    t = np.where(dead, 0.0, np.where(valid, rng.uniform(0.2, 4.0, n), 1e4))
    mat = np.where(valid, rng.integers(0, 3, n), 0).astype(np.int32)
    st = np.zeros((9, n), np.float32)
    st[0] = t
    st[1] = valid.astype(np.int32).view(np.float32)
    st[2] = mat.view(np.float32)
    st[3] = np.where(valid, 1, -1).astype(np.int32).view(np.float32)
    st[4:7] = rng.normal(size=(3, n)) * rng.uniform(0.5, 2.0, n)
    st[7:9] = rng.uniform(0.0, 0.5, (2, n))
    miss = ((rng.uniform(size=n) < 0.5) & dead).astype(np.int32)
    return rays, st.reshape(9, P, K), miss.reshape(P, K)


def _acc_inputs():
    """occ, ab, lit, tmp, decay_p of the accumulate pass."""
    rng = np.random.default_rng(12)
    occ = (rng.uniform(size=(P, K)) < 0.3).astype(np.int32)
    ab = rng.uniform(0.0, 1.0, (2, P, K)).astype(np.float32)
    lit = (rng.uniform(size=(P, K)) < 0.6).astype(np.int32)
    tmp = rng.uniform(0.0, 2.0, (3, P, K)).astype(np.float32)
    decay = (0.9 ** (np.arange(P) % 4)).astype(np.float32)
    return occ, ab, lit, tmp, decay


def _jax_side(out_path):
    """raytpu's K3 and K4 on the inputs above, into an npz."""
    import jax.numpy as jnp

    from raytpu.ops.epilogue import accumulate_epilogue, shade_epilogue

    def tile(a):
        return jnp.asarray(a.reshape(*a.shape[:-1], 8, 128))

    light = (jnp.asarray(LIGHT_POS, jnp.float32),
             jnp.asarray(LIGHT_INTENSITY, jnp.float32))
    rays, st, miss = _shade_inputs()
    shade = shade_epilogue(tile(rays), tile(st), tile(miss), *light)
    occ, ab, lit, tmp, decay = _acc_inputs()
    acc = accumulate_epilogue(tile(occ), tile(ab), tile(lit), tile(tmp),
                              jnp.asarray(decay), *light)
    flat = {name: np.asarray(x).reshape(*x.shape[:-3], P, K)
            for name, x in zip(SHADE_OUT, shade)}
    np.savez(out_path, tmp=np.asarray(acc).reshape(3, P, K), **flat)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("epilogue") / "jax_side.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def test_shade_ref_matches_k3(jax_side):
    rays, st, miss = _shade_inputs()
    got = epilogue.shade_epilogue_ref(torch.from_numpy(rays.copy()),
                                      torch.from_numpy(st),
                                      torch.from_numpy(miss.copy()),
                                      LIGHT_POS, LIGHT_INTENSITY)
    got = dict(zip(SHADE_OUT, (x.numpy() for x in got)))
    for name in ("lit", "miss"):
        np.testing.assert_array_equal(got[name], jax_side[name], err_msg=name)
    for name in ("srays", "swin", "ab", "nrays", "nwin"):
        np.testing.assert_allclose(got[name], jax_side[name], rtol=0,
                                   atol=2e-6, err_msg=name)
    for name in ("srays", "swin", "nrays", "nwin"):   # bitwise without FMA
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      jax_side[name].view(np.int32), err_msg=name)
    np.testing.assert_array_equal(got["ab"][0].view(np.int32),
                                  jax_side["ab"][0].view(np.int32))

    # the inputs reach every branch of K3
    valid = st[1].view(np.int32) != 0
    mat = st[2].view(np.int32)
    lit = got["lit"] != 0
    assert (got["miss"] - miss).sum() > 1000                  # new misses
    assert lit.sum() > 1000
    assert ((mat == 0) & valid & ~lit).sum() > 1000           # backfaces
    cont = got["nwin"] > 0
    assert cont.sum() == (valid & (mat > 0)).sum()
    n = st[4:7] / np.linalg.norm(st[4:7], axis=0)
    ddn = (rays[3:] * n).sum(0)
    ratio = np.where(ddn > 0, 1.52, 1 / 1.52)
    tir = 1.0 - ratio ** 2 * (1.0 - ddn ** 2) < 0.0
    assert (valid & (mat == 2) & tir).sum() > 1000            # TIR lanes


def test_accumulate_ref_matches_k4(jax_side):
    occ, ab, lit, tmp, decay = _acc_inputs()
    got = epilogue.accumulate_epilogue_ref(
        torch.from_numpy(occ), torch.from_numpy(ab), torch.from_numpy(lit),
        torch.from_numpy(tmp.copy()), torch.from_numpy(decay), LIGHT_POS,
        LIGHT_INTENSITY).numpy()
    np.testing.assert_allclose(got, jax_side["tmp"], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.view(np.int32),
                                  jax_side["tmp"].view(np.int32))
    assert (got != tmp).any(axis=0).mean() > 0.3


@pytest.mark.parametrize("p", [128, 512, 1024, 2048, 8192, 2112])
def test_wave_schedule_matches_raytpu(p):
    budget = integrator._wave_budget(p)
    assert budget == ji._wave_budget(p)
    if budget:
        assert integrator._wave_rungs(p, budget) == ji._wave_rungs(p, budget)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _renderer(bounces: int, t_anim: float):
    """The three-material scene at 512x130, spp 1: 80 tiles padded to
    P = 128 packets, so the budget is 64 and compaction engages."""
    r = Renderer(scenes.mixed_scene(512, 130, 1, bounces,
                                    camera_position=(0.0, 1.0, 9.0)), "cpu")
    r.set_transforms(t_anim)
    return r


def _frame(r, **knobs):
    """The frame of ``r`` with RenderStatic ``knobs``, and the packet width
    of each fused bounce step."""
    widths = []
    step = integrator._fused_step

    def spy(ts, rs, rays, *args):
        widths.append(rays.shape[1])
        return step(ts, rs, rays, *args)

    rs = dataclasses.replace(r.render_static, **knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, "_fused_step", spy)
        img = render_frame(r.tscene, rs, r.camera_tensor())
    return img, widths


@functools.lru_cache(maxsize=None)
def _full_frame(bounces: int, t_anim: float):
    """The full-width fused frame of :func:`_renderer` and its step widths."""
    return _frame(_renderer(bounces, t_anim), wavefront="full")


@pytest.mark.parametrize("rungs", ["auto", "patched"])
def test_compact_frame_equals_full_width(rungs, monkeypatch):
    r = _renderer(3, 0.0)
    full, full_w = _full_frame(3, 0.0)
    assert full_w == [128] * 4
    if rungs == "patched":
        monkeypatch.setattr(integrator, "_wave_rungs",
                            lambda p, b, max_rungs=3: [b, 16])
    compact, widths = _frame(r)
    assert integrator._wave_budget(128) == 64
    # the peeled full-width bounce, then two waves of 64 per bounce
    assert widths == [128] + [64] * 6, widths
    assert full.std() > 0.05
    assert torch.equal(compact, full)


def test_ladder_phase_transition(monkeypatch):
    """Deep TIR paths keep some packets live for 12 bounces: the patched
    ladder runs waves of 64, then of 16 once the live prefix fits."""
    r = _renderer(12, 1.3)
    full, _ = _full_frame(12, 1.3)
    single, single_w = _frame(r, ladder="off")
    monkeypatch.setattr(integrator, "_wave_rungs",
                        lambda p, b, max_rungs=3: [b, 16])
    ladder, widths = _frame(r)
    assert set(single_w) == {128, 64}
    assert 64 in widths and widths[-1] == 16, widths
    assert torch.equal(ladder, full)
    assert torch.equal(single, full)


if __name__ == "__main__":
    # the JAX side, in a process whose XLA_FLAGS the parent set
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_side(sys.argv[1])
