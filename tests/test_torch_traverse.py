"""Plain sweeps of the PyTorch port against the JAX traversal, through
raytpu's own chunked ``bvh_*`` arrays (``from_raytpu``), on 8 packets x
1024 seeded rays with dead lanes:

* ``closest_sweep_ref`` against the chain of ``pallas_closest_chain`` over
  ``traversal_list`` (interpret mode): valid, mat and inst exact; t, u and
  v within 4 f32 ulps; the normal within 1e-6;
* the hit triangle against ``trace.closest_hit`` (``bvh_closest``): exact;
* ``anyhit_sweep_ref`` flags against ``pallas_anyhit_chain``: exact.

The per-lane tier's plain sweeps (``perlane_closest_sweep_ref``,
``perlane_anyhit_sweep_ref``: K1 and K2's function, culled by block,
entries reordered, walks near child first) and the consensus tier's
(``mega_closest_sweep_ref``, ``mega_anyhit_sweep_ref``: K8 and K9's, the
same schedule, warps walking the wide links) are held to the same bars as
further cases: the per-lane and megakernel Pallas kernels run only on a
TPU, where ``raytpu.bench.bit_identity_check`` holds them to this same
chain.

The chains call raytpu's kernels ``_closest_kernel3``/``_anyhit_kernel3``
through the ``pallas_call`` of ``pallas_*_chain`` with each entry's tables
(``_mesh_tables``) passed as operands rather than closed over, so that one
interpret-mode compile serves every entry.

The JAX side runs in a child process with ``--xla_cpu_max_isa=AVX``: that
ISA has no fused multiply-add, so XLA:CPU rounds every ``a*b + c`` twice,
as the port does (and the CUDA kernels, built with ``--fmad=false``). With
the cap, port and chain agree bit for bit on this rig (measured: 0 ulps on
t, u and v, 0 on the normal). Without it XLA:CPU contracts the chain's
products into FMAs and Moller-Trumbore's cancelling dot products amplify
the single rounding: measured up to 13 ulps of t, 1.5e-5 absolute on u and
v and 3.5e-6 on the normal, with the same hits, materials and instances.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytpu.ops import trace as jtrace
from raytpu.ops import traverse_pallas as tp
from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import scenes
from raytpu_torch.device_scene import from_raytpu
from raytpu_torch.ops import consensus, perlane, traverse
from tests.torch_twin import raytpu_twin

P, K = 8, tp.PACKET_K
TMIN = 1e-3
T_ANIM = 0.1
NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent


@functools.partial(jax.jit, static_argnums=(0,))
def _closest_chain_call(tmin, end, w2o12, matid, instid, boxes, meta, tris,
                        normals, live, rays, state):
    p = rays.shape[1]
    blk = (6, tp.PACK_N, tp.K_SUB, tp.K_LANE)
    ray_spec = pl.BlockSpec(blk, lambda i: (0, i, 0, 0),
                            memory_space=pltpu.VMEM)
    st_spec = pl.BlockSpec((9,) + blk[1:], lambda i: (0, i, 0, 0),
                           memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(tp._closest_kernel3, tmin=tmin),
        grid=(p // tp.PACK_N,), interpret=True,
        in_specs=[tp._SMEM] * 32 + [ray_spec, st_spec],
        out_specs=st_spec,
        out_shape=jax.ShapeDtypeStruct((9, p, tp.K_SUB, tp.K_LANE),
                                       jnp.float32),
        input_output_aliases={33: 0},
    )(end, w2o12, matid, instid, *boxes, *meta, *tris, *normals, live, rays,
      state)


@functools.partial(jax.jit, static_argnums=(0,))
def _anyhit_chain_call(tmin, end, w2o12, boxes, meta, tris, live, rays,
                       tmax_reg, occ):
    p = rays.shape[1]
    vspec = pl.BlockSpec((tp.PACK_N, tp.K_SUB, tp.K_LANE),
                         lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    ray_spec = pl.BlockSpec((6, tp.PACK_N, tp.K_SUB, tp.K_LANE),
                            lambda i: (0, i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(tp._anyhit_kernel3, tmin=tmin),
        grid=(p // tp.PACK_N,), interpret=True,
        in_specs=[tp._SMEM] * 21 + [ray_spec, vspec, vspec],
        out_specs=vspec,
        out_shape=jax.ShapeDtypeStruct((p, tp.K_SUB, tp.K_LANE), jnp.int32),
        input_output_aliases={23: 0},
    )(end, w2o12, *boxes, *meta, *tris, live, rays, tmax_reg, occ)


def _jax_renderer():
    jr = JaxRenderer(raytpu_twin(scenes.mixed_scene(
        32, 32, 1, 1, depth=2, chunk_tris=128, traversal="pallas")))
    jr.set_transforms(T_ANIM)
    return jr


def _inputs():
    """Seeded rays (6, P, K), closest window (P, K) with dead lanes and a
    dead packet, shadow window (P, K)."""
    rng = np.random.default_rng(2024)
    n = P * K
    u = rng.normal(size=(n, 3))
    o = u / np.linalg.norm(u, axis=1, keepdims=True) * rng.uniform(8, 14, (n, 1))
    d = rng.uniform(-3.5, 3.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o.T, d.T]).astype(np.float32).reshape(6, P, K)
    win = np.full((P, K), 1e4, np.float32)
    win.reshape(-1)[3::7] = 0.0   # dead lanes
    win[5] = 0.0                  # one dead packet
    rng = np.random.default_rng(7)
    tmax = np.where(win > 0, rng.uniform(0.0, 25.0, win.shape), 0.0).astype(
        np.float32)
    return rays, win, tmax


def _scene_arrays(ts):
    return {f"scene_{f.name}": getattr(ts, f.name).numpy()
            for f in ts.__dataclass_fields__.values()
            if isinstance(getattr(ts, f.name), torch.Tensor)}


def _jax_side(out_path):
    """The JAX chains and ``closest_hit`` on :func:`_inputs`, into an npz,
    with the scene tables they traced (to check the parent traces the
    same)."""
    jr = _jax_renderer()
    dev, static = jr.device_scene, jr.static
    rays, win, tmax = _inputs()
    rays_r = jnp.asarray(rays.reshape(6, P, tp.K_SUB, tp.K_LANE))
    tmax_r = jnp.asarray(tmax.reshape(P, tp.K_SUB, tp.K_LANE))

    state = tp.make_trace_state(jnp.asarray(win))
    live = jnp.any(jnp.asarray(win) > TMIN, axis=1).astype(jnp.int32)
    for inst, mesh in static.traversal_list:
        end, boxes, meta, tris, normals = tp._mesh_tables(dev, static, mesh)
        state = _closest_chain_call(
            TMIN, end, dev.w2o[inst].reshape(12), dev.materials[inst].reshape(1),
            jnp.asarray([inst], jnp.int32), boxes, meta, tris, normals, live,
            rays_r, state)

    o = jnp.asarray(rays[:3].reshape(3, -1).T)
    d = jnp.asarray(rays[3:].reshape(3, -1).T)
    ref = jtrace.closest_hit(dev, static, o, d, TMIN, jnp.asarray(win.ravel()))

    occ = jnp.zeros((P, tp.K_SUB, tp.K_LANE), jnp.int32)
    live = jnp.any(jnp.asarray(tmax) > TMIN, axis=1).astype(jnp.int32)
    for inst, mesh in static.traversal_list:
        end, boxes, meta, tris, _ = tp._mesh_tables(dev, static, mesh)
        occ = _anyhit_chain_call(TMIN, end, dev.w2o[inst].reshape(12), boxes,
                                 meta, tris, live, rays_r, tmax_r, occ)

    np.savez(out_path, state=np.asarray(state).reshape(9, P, K),
             prim=np.asarray(ref.prim), inst=np.asarray(ref.inst),
             occ=np.asarray(occ).reshape(P, K),
             **_scene_arrays(from_raytpu(dev, static, "cpu")))


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    jr = _jax_renderer()
    assert len(jr.static.traversal_list) >= 5  # several chunks per mesh
    ts = from_raytpu(jr.device_scene, jr.static, "cpu")

    out = tmp_path_factory.mktemp("chain") / "jax_side.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(out))
    for name, arr in _scene_arrays(ts).items():   # both trace one scene
        np.testing.assert_array_equal(arr, want[name], err_msg=name)
    return ts, want


def _within_ulps(a, b, n):
    tol = n * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a - b) <= tol


CLOSEST = {"chained": traverse.closest_sweep_ref,
           "perlane": perlane.perlane_closest_sweep_ref,
           "consensus": consensus.mega_closest_sweep_ref}
ANYHIT = {"chained": traverse.anyhit_sweep_ref,
          "perlane": perlane.perlane_anyhit_sweep_ref,
          "consensus": consensus.mega_anyhit_sweep_ref}


@pytest.mark.parametrize("sweep", ["chained", "perlane", "consensus"])
def test_closest_ref_matches_pallas_chain_and_bvh_closest(rig, sweep):
    ts, jax_side = rig
    rays, win, _ = _inputs()

    slots = torch.full((P, K), -1, dtype=torch.long)
    got = CLOSEST[sweep](
        ts, torch.from_numpy(rays), TMIN,
        traverse.make_trace_state(torch.from_numpy(win)), slots).numpy()
    want = jax_side["state"]

    gi, wi = got.view(np.int32), want.view(np.int32)
    for plane in (traverse.ST_VALID, traverse.ST_MAT, traverse.ST_INST):
        np.testing.assert_array_equal(gi[plane], wi[plane])
    hit = gi[traverse.ST_VALID] != 0
    assert 0.2 < hit.mean() < 0.9, hit.mean()
    for plane in (traverse.ST_T, traverse.ST_U, traverse.ST_V):
        assert _within_ulps(got[plane], want[plane], 4).all(), plane
    np.testing.assert_allclose(got[traverse.ST_NX:traverse.ST_NZ + 1],
                               want[traverse.ST_NX:traverse.ST_NZ + 1],
                               rtol=0, atol=1e-6)

    # hit triangle and instance against the per-ray XLA walk
    prim = np.where(hit.ravel(),
                    ts.bvh_tri_prim.numpy()[slots.numpy().ravel().clip(0)], -1)
    np.testing.assert_array_equal(prim, jax_side["prim"])
    np.testing.assert_array_equal(
        np.where(hit, gi[traverse.ST_INST], -1).ravel(), jax_side["inst"])


@pytest.mark.parametrize("sweep", ["chained", "perlane", "consensus"])
def test_anyhit_ref_matches_pallas_chain(rig, sweep):
    ts, jax_side = rig
    rays, _, tmax = _inputs()
    got = ANYHIT[sweep](
        ts, torch.from_numpy(rays), TMIN, torch.from_numpy(tmax),
        torch.zeros((P, K), dtype=torch.int32)).numpy()
    want = jax_side["occ"]
    np.testing.assert_array_equal(got, want)
    assert 0.1 < (want != 0).mean() < 0.9


if __name__ == "__main__":
    # the JAX side, in a process whose XLA_FLAGS the parent set
    jax.config.update("jax_platforms", "cpu")
    _jax_side(sys.argv[1])
