"""Tile-row sharding of the PyTorch port (``raytpu_torch/parallel``) on the
CPU, with the kernels' plain versions, against the port's single-device
frame and against raytpu's sharded frame.

The scene is the asset-free three-material ``scenes.mixed_scene(64, 48,
spp=2, bounces=3)`` at ``set_transforms(0.25)``: 2 tile rows, so meshes of
3, 4, 5 and 8 slots have slots whose rows are all padding. Its frames have
no exact tie, and the plain versions follow the kernels' tie rules, so
every tier's sharded frame equals its single-device frame bit for bit.

raytpu's frames render in a child process whose XLA:CPU has no fused
multiply-add (``--xla_cpu_max_isa=AVX``, as in ``test_torch_options.py``)
and 8 virtual host devices (``conftest.py``): with FMA, XLA fuses the
sharded program otherwise than the single-device one, and the chaotic
shader hash turns that rounding into other jitter (measured: raytpu's
sharded frame not equal to its own frame with FMA, equal without).
"""

import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytpu_torch import _build, integrator, scenes
from raytpu_torch.integrator import render_frame
from raytpu_torch.parallel import Mesh, make_mesh, render_frame_sharded, render_sharded, replicate
from raytpu_torch.render import Renderer
from raytpu_torch.utils.ssim import ssim
from tests.torch_twin import one_thread, twin

T_ANIM = 0.25
NO_FMA = "--xla_cpu_max_isa=AVX"
REPO = Path(__file__).resolve().parent.parent


def _scene():
    return scenes.mixed_scene(64, 48, spp=2, bounces=3)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def port():
    """The port's Renderer of the twin scene, posed, and its single-device
    frame with its stats."""
    _, scene = twin(_scene())
    r = Renderer(scene, "cpu")
    r.set_transforms(T_ANIM)
    stats = {}
    with one_thread():
        img = render_frame(r.tscene, r.render_static, r.camera_tensor(), stats=stats)
    return r, img, stats


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    """raytpu's single-device and 8-device sharded frames of the twin scene,
    rendered in one child process without FMA."""
    out = tmp_path_factory.mktemp("parallel") / "frames.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_sharded_frame_equals_single_device(port, n):
    r, want, want_stats = port
    stats = {}
    got = render_sharded(r.tscene, r.render_static, r.camera_tensor(),
                         make_mesh(n, "cpu"), stats=stats)
    assert got.shape == want.shape == (48, 64, 3) and want.std() > 0.05
    assert torch.equal(got, want)
    # the same lanes traced, each slot's syncs counted once
    for key in ("closest_rays", "shadow_rays"):
        assert int(stats[key]) == int(want_stats[key])
    assert stats["tier"] == want_stats["tier"]
    assert len(stats["slots"]) == n
    assert stats["host_syncs"] == sum(s["host_syncs"] for s in stats["slots"])


@pytest.mark.parametrize("traversal", ["pallas", "perlane", "mega", "xla"])
def test_sharded_tier_frame_equals_single_device(port, traversal):
    r, _, _ = port
    ts = dataclasses.replace(r.tscene, traversal=traversal)
    want = render_frame(ts, r.render_static, r.camera_tensor())
    stats = {}
    got = render_sharded(ts, r.render_static, r.camera_tensor(),
                         make_mesh(2, "cpu"), stats=stats)
    assert stats["tier"] == traversal
    assert torch.equal(got, want)


def test_sharded_frames_against_raytpu(port, jax_frames):
    """raytpu's sharded frame equals its own single-device frame bit for
    bit, and the port's 8-slot frame holds the end-to-end bar of
    ``test_torch_frame.test_renderer_frame_ssim_against_raytpu`` against
    raytpu's sharded frame."""
    r, _, _ = port
    want = jax_frames["sharded"]
    np.testing.assert_array_equal(want, jax_frames["single"])
    got = render_sharded(r.tscene, r.render_static, r.camera_tensor(),
                         make_mesh(8, "cpu")).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert ssim(got, want) > 0.98


def test_render_frame_sharded_returns_the_slots_slabs(port):
    """One slab per slot, on its slot's device, of the rows raytpu's
    padding gives (``h_pad = ceil(h_t / n) * n`` tile rows, ``h_pad / n``
    a slot); cropped and stacked they are the frame."""
    r, want, _ = port
    mesh = make_mesh(5, "cpu")
    slabs = render_frame_sharded(replicate(r.tscene, mesh), r.render_static,
                                 r.camera_tensor(), mesh)
    h_t = -(-48 // 32)
    hl = -(-h_t // 5)
    assert [tuple(s.shape) for s in slabs] == [(hl * 32, 64, 3)] * 5
    assert all(s.device == d for s, d in zip(slabs, mesh.devices))
    assert torch.equal(torch.cat(slabs)[:48], want)


def test_make_mesh():
    assert make_mesh(device="cpu").size == 1
    mesh = make_mesh(3, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert Mesh(["cuda:0"] * 4).distinct() == (torch.device("cuda", 0),)
    assert Mesh(["cuda"]).devices == (torch.device("cuda", 0),)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="at least one"):
            make_mesh(bad, "cpu")
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "cuda:0"])


def test_make_mesh_cuda_names_the_count():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs fewer cards")
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        make_mesh(2, "cuda")
    with pytest.raises(ValueError, match="requested 2 devices, have 0"):
        Renderer(scenes.mixed_scene(64, 48, 2, 3, devices=2))


def test_renderer_with_devices_equals_one_device(port):
    """``Renderer`` with ``devices=4`` on the CPU renders the frame of
    ``devices=1`` at each pose: its replicas follow ``set_transforms``,
    and a replaced scene is replicated anew."""
    _, want, _ = port
    _, scene = twin(_scene())
    r1 = Renderer(scene, "cpu")
    scene.config = scene.config.replace(devices=4)
    r4 = Renderer(scene, "cpu")
    assert r1.mesh is None and r1.devices == (torch.device("cpu"),)
    assert r4.mesh.size == 4 and r4.devices == (torch.device("cpu"),)
    for x in (r1, r4):
        x.set_transforms(T_ANIM)
    assert torch.equal(r4.render(), want)
    first = r4.replicas
    assert len(first) == 4 and len({id(ts) for ts in first}) == 4
    for x in (r1, r4):
        x.set_transforms(0.5)
    assert r4.replicas is not first
    assert torch.equal(r4.render(), r1.render())
    r4.tscene = dataclasses.replace(r4.tscene, traversal="pallas")
    assert all(ts.traversal == "pallas" for ts in r4.replicas)


def test_a_slot_exception_reaches_the_caller(port):
    r, _, _ = port
    seen = []

    def boom(camera, s_row, px, *args):
        seen.append(threading.current_thread().name)
        raise RuntimeError(f"slot raygen {len(seen)}")

    with integrator.kernels(raygen=boom), pytest.raises(RuntimeError,
                                                        match="slot raygen"):
        render_sharded(r.tscene, r.render_static, r.camera_tensor(),
                       make_mesh(3, "cpu"))
    assert len(seen) == 3 and all(n.startswith("raytpu-slot") for n in seen)


def test_synchronize_drains_each_card_once(monkeypatch):
    """The timer of a sharded frame drains every card the mesh used, each
    once, and no card for CPU slots."""
    from raytpu_torch.utils import timing

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timing.synchronize(make_mesh(3, "cpu").distinct())
    assert synced == []
    timing.synchronize(Mesh(("cuda:0", "cuda:1", "cuda:0")).distinct())
    assert synced == [torch.device("cuda", 0), torch.device("cuda", 1)]
    synced.clear()
    timing.measure_frame(lambda: torch.zeros(1), warmup=1, iters=2,
                         devices=("cuda:1",))
    assert synced == [torch.device("cuda", 1)] * 2


class _FakeLib:
    """Stands in for the kernel library: every entry point succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


def _fake_card(monkeypatch):
    """``_build.launch`` as on a machine with a card, the library a fake."""
    monkeypatch.setattr(_build, "library", lambda: _FakeLib())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_launch_refuses_operands_on_two_devices(monkeypatch):
    """A launch, and ``check_operands``, refuse operands on two devices (a
    CPU and a meta tensor stand for two cards; the device type check is
    lifted for ``check_operands``)."""
    _fake_card(monkeypatch)
    _build.reset_launch_counts()
    a = torch.zeros(4)
    b = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="lie on 2 devices"):
        _build.launch("sky", _build.Pointer(a), 3, _build.Pointer(b))
    monkeypatch.setattr(_build, "_check", _build._check_layout)
    with pytest.raises(ValueError, match="lie on 2 devices"):
        _build.check_operands("sky", [("a", a, (4,), torch.float32),
                                      ("b", b, (4,), torch.float32)])
    _build.launch("sky", _build.Pointer(a), 3, _build.Pointer(a))
    assert _build.launch_counts()["sky"] == 1
    _build.reset_launch_counts()


def test_launch_counts_from_many_threads(monkeypatch):
    """The counters lose no launch when more threads than cores launch at
    once, with the interpreter switching threads as often as it can."""
    _fake_card(monkeypatch)
    _build.reset_launch_counts()
    ptr = _build.Pointer(torch.zeros(4))
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 500
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.launch("raygen", ptr) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert _build.launch_counts()["raygen"] == n_threads * per_thread
    _build.reset_launch_counts()


if __name__ == "__main__":
    # raytpu's frames, in a process whose XLA_FLAGS the parent set
    import jax.numpy as jnp

    from raytpu.integrator import render_frame as jax_render_frame
    from raytpu.parallel import make_mesh as jax_make_mesh
    from raytpu.parallel import render_sharded as jax_render_sharded
    from raytpu.render import Renderer as JaxRenderer

    jax.config.update("jax_platforms", "cpu")
    jscene, _ = twin(_scene())
    jr = JaxRenderer(jscene)
    jr.set_transforms(T_ANIM)
    cam = jnp.asarray(jr.camera.basis())
    single = jax_render_frame(jr.device_scene, jr.static, jr.render_static, cam)
    sharded = jax_render_sharded(jr.device_scene, jr.static, jr.render_static,
                                 cam, jax_make_mesh(8))
    assert len(sharded.sharding.device_set) == 8
    np.savez(sys.argv[1], single=np.asarray(single), sharded=np.asarray(sharded))
