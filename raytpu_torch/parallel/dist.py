"""Tile-row sharding of a frame over several devices (counterpart of
``raytpu/parallel/dist.py``).

raytpu shards whole tile rows of the 32x32 tile-major packet stream over a
1-D device mesh with ``shard_map``: the scene is replicated on each
device, each device runs the unchanged single-device hot path on its own
slice of packets and detiles its own row slab, and no collective runs
inside a frame; the only traffic between devices is the gather of the
finished slabs.

The port does the same in one process: one scene replica per mesh slot
(``TorchScene.to``), one host thread per slot (as
``torch.nn.parallel.parallel_apply`` runs one), and the slabs copied to
the first slot's device. A thread per slot and not one loop, because the
bounce loop waits on the host once per bounce (``stats["host_syncs"]``),
so one loop would serialize the cards; PyTorch's ops and the kernels'
ctypes calls release the interpreter lock while they run. Each slot's
thread has its slot's card current (``torch.cuda.device``), and every
kernel launch goes to its operands' card (``_build.launch``).

A mesh may repeat a device (``Mesh([cuda:0] * 4)``): the slots' threads
then share that card and its stream, which is correct but serial. On the
CPU, ``make_mesh(n, "cpu")`` gives ``n`` slots of the one CPU device, the
counterpart of the JAX package's virtual host devices.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from raytpu_torch.device_scene import TorchScene
from raytpu_torch.integrator import render_packets
from raytpu_torch.ops.mega import BLOCK_PACKETS


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of device slots (``jax.sharding.Mesh`` over one axis):
    slot ``i`` renders the ``i``-th slice of tile rows on ``devices[i]``.
    A device may occupy several slots."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a mesh's devices are of one type ({devices})")
        # a CUDA slot names its card, so that threads make that card current
        devices = tuple(torch.device("cuda", d.index or 0)
                        if d.type == "cuda" and d.index is None else d
                        for d in devices)
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in slot order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``device``'s type
    (``raytpu/parallel/dist.py:36``): on "cuda" the first cards, all of them
    by default, raising when fewer exist; on "cpu" ``n_devices`` slots of
    the one CPU device (default 1)."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        have = n
        devs = [torch.device("cpu")] * n
    elif kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        devs = [torch.device("cuda", i) for i in range(min(n, have))]
    else:
        raise ValueError(f"no mesh over {kind} devices (use 'cuda' or 'cpu')")
    if n < 1:
        raise ValueError(f"requested {n} devices: a mesh needs at least one")
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh(tuple(devs))


def replicate(ts: TorchScene, mesh: Mesh) -> list:
    """One replica of ``ts`` per slot of ``mesh``, on the slot's device
    (:meth:`TorchScene.to`)."""
    return [ts.to(dev) for dev in mesh.devices]


def _on(device: torch.device):
    """The block with ``device`` current, for a CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _slot_pixels(rs, rows: range, w_t: int, device):
    """The tile-major pixel packets of the tile rows ``rows`` (the same
    construction as ``integrator.tiled_pixels``; rows past the frame are
    dead), padded with dead packets to a ``BLOCK_PACKETS`` multiple:
    ``(px, py, in_frame)``, each (P, K)."""
    t = rs.tile
    ty, tx = torch.meshgrid(torch.arange(rows.start, rows.stop, device=device),
                            torch.arange(w_t, device=device), indexing="ij")
    iy, ix = torch.meshgrid(torch.arange(t, device=device),
                            torch.arange(t, device=device), indexing="ij")
    xs = tx.reshape(-1, 1) * t + ix.reshape(1, -1)
    ys = ty.reshape(-1, 1) * t + iy.reshape(1, -1)
    in_frame = (xs < rs.width) & (ys < rs.height)
    px = torch.clamp_max(xs, rs.width - 1).to(torch.float32)
    py = torch.clamp_max(ys, rs.height - 1).to(torch.float32)
    pad = (-px.shape[0]) % BLOCK_PACKETS
    if pad:
        px, py, in_frame = (torch.cat([x, x.new_zeros((pad, x.shape[1]))])
                            for x in (px, py, in_frame))
    return px, py, in_frame


def _merge_stats(stats: dict, slots: Sequence[dict], device) -> None:
    """Add the slots' stats to ``stats``: device counters summed on
    ``device``, host counts summed, the ``tier`` once (the same in every
    slot, or this raises); ``stats["slots"]`` lists each slot's packets a
    wave and host syncs."""
    for key in sorted({k for s in slots for k in s}):
        vals = [s[key] for s in slots if key in s]
        if isinstance(vals[0], str):
            if len(set(vals)) > 1:
                raise RuntimeError(f"the slots' {key} differ: {vals}")
            stats[key] = vals[0]
        elif isinstance(vals[0], torch.Tensor):
            total = sum(v.to(device) for v in vals)
            stats[key] = total if key not in stats else stats[key] + total
        else:
            stats[key] = stats.get(key, 0) + sum(vals)
    stats["slots"] = [{"packets": s["packets"], "host_syncs": s.get("host_syncs", 0)}
                      for s in slots]


def render_frame_sharded(replicas: Sequence[TorchScene], rs, camera: torch.Tensor,
                         mesh: Mesh, stats: Optional[dict] = None) -> list:
    """The frame's tile rows rendered over ``mesh``, one slot a thread
    (``raytpu/parallel/dist.py:46``) -> the slots' row slabs, slab ``i``
    (rows, W, 3) on ``mesh.devices[i]``.

    The tile-row grid is padded to ``h_pad = ceil(h_t / n) * n`` rows, and
    each slot renders ``h_pad / n`` whole rows: its packets, padded with
    dead ones to a ``BLOCK_PACKETS`` multiple (not the single-device
    frame's ``SEG_PACKETS``), go through ``integrator.render_packets`` with
    ``replicas[i]`` (so ``ray_chunk`` does not apply inside a slot, as in
    the JAX package), and the slot detiles its own rows on its device. A
    slot whose rows are all padding renders dead packets only. An
    exception in any slot is raised here. ``stats``, if a dict, receives
    the slots' stats merged (:func:`_merge_stats`)."""
    n = mesh.size
    if len(replicas) != n:
        raise ValueError(f"{len(replicas)} scene replicas for a mesh of {n} slots")
    for i, (ts, dev) in enumerate(zip(replicas, mesh.devices)):
        if ts.o2w.device != dev:
            raise ValueError(f"slot {i}'s scene lies on {ts.o2w.device}, "
                             f"the slot on {dev}")
    t = rs.tile
    w_t = -(-rs.width // t)
    h_t = -(-rs.height // t)
    hl = -(-h_t // n)                 # tile rows a slot (h_pad / n)

    def slot(i: int):
        dev = mesh.devices[i]
        slot_stats = {} if stats is not None else None
        with _on(dev):
            px, py, act = _slot_pixels(rs, range(i * hl, (i + 1) * hl), w_t, dev)
            colors = render_packets(replicas[i], rs, camera.to(dev), px, py, act,
                                    stats=slot_stats)
            img = torch.stack([c[: hl * w_t] for c in colors], dim=-1)
            img = (img.reshape(hl, w_t, t, t, 3).permute(0, 2, 1, 3, 4)
                   .reshape(hl * t, w_t * t, 3)[:, : rs.width])
        if slot_stats is not None:
            slot_stats["packets"] = px.shape[0] * rs.samples_per_pixel
        return img, slot_stats

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="raytpu-slot") as pool:
        futures = [pool.submit(slot, i) for i in range(n)]
    # the pool has joined every thread; result() raises a slot's exception
    done = [f.result() for f in futures]
    if stats is not None:
        _merge_stats(stats, [s for _, s in done], mesh.devices[0])
    return [img for img, _ in done]


def render_sharded(scene: Union[TorchScene, Sequence[TorchScene]], rs,
                   camera: torch.Tensor, mesh: Optional[Mesh] = None,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """The sharded frame (``raytpu/parallel/dist.py:136``) -> (H, W, 3) f32
    on ``mesh.devices[0]``: ``scene`` is a scene, replicated here over the
    mesh, or the replicas themselves (one per slot, :func:`replicate`);
    ``mesh`` defaults to every device of the scene's type."""
    replicas = [scene] if isinstance(scene, TorchScene) else list(scene)
    if mesh is None:
        mesh = make_mesh(device=replicas[0].o2w.device.type)
    if isinstance(scene, TorchScene):
        replicas = replicate(scene, mesh)
    slabs = render_frame_sharded(replicas, rs, camera, mesh, stats=stats)
    first = mesh.devices[0]
    return torch.cat([s.to(first) for s in slabs])[: rs.height]
