"""CUDA graphs of the fused bounce loop: a frame's work between two host
reads, replayed with no launch from Python.

The fused loop runs a schedule, ``integrator.loop_ops``: units of work
and the host reads between them (the live prefix length ``n_eff`` once a
compacted iteration, ``any(window > 0)`` once a bounce without a budget;
and inside a bounce ``any(lit)`` where the shadow-skip rule applies).
Eagerly ``integrator._FusedLoop`` runs each unit as it comes. A
:class:`FramePlan` captures each unit a frame can replay
(:func:`plan_units`; a bounce with an ``any(lit)`` read as its two halves)
once as a CUDA graph, enqueued by that same ``_FusedLoop``, and a frame
drives the same schedule over replays: the raygen, then inside
``rt.loop`` the loop's units with each read between two replays, then
the sky and the spp mean; the detile runs eagerly, so each frame's image
is a new tensor.

The graphs replay the kernels and operations the eager loop launches, in
its order, on the same data, so a replayed frame equals the eager frame
bit for bit, and the reads keep their count (each ``integrator._read``).
A replay counts its graph's kernel launches (``_build.add_launches``).

The plan owns every tensor its graphs read or write, at fixed addresses:
the camera and the instance transforms ``o2w``/``w2o`` (refreshed with a
device copy before each frame's first replay, since ``Renderer`` builds
new ones every frame and K7 and the sweeps read them), the pixel, active
and sample-index rows, the loop's buffers and every unit's outputs, from
one memory pool the plan's graphs share (:class:`FramePlan` says why
that is sound). It holds the scene's other tables by reference: a scene
whose tables are other objects, or whose other fields differ, gets a new
plan (:meth:`FramePlan.fits`). A plan captures all its units when it is
made, after its first frame rendered eagerly, so no capture falls inside
later frames.

Only what the code can observe decides (:func:`graphable`): a frame on
one CUDA device that ``integrator.render_frame`` renders as one wave of
the fused loop, with no ``stats``, no work counting, no validation and
the kernel wrappers in place. Every other frame, the CPU's among them,
takes ``integrator.render_frame`` and touches no graph.

Spans: ``rt.graph.capture`` around each capture, ``rt.graph.replay``
around each replay, ``rt.later`` around the replays of each unit past
the first bounce, as around the unit in an eager frame. The captured
work records its own spans only while captured, so a replayed frame
shows none of ``rt.prepass``, ``rt.sweep.*``, ``rt.shade`` or
``rt.accumulate``; their work runs inside the replays."""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch

from raytpu_torch import _build, integrator
from raytpu_torch.utils.spans import span

# frame shapes a renderer keeps plans for (a window resize is a new one);
# the least recently used goes first
MAX_PLANS = 4
# the scene fields a plan copies into its own tensors before each frame
REFRESHED = ("o2w", "w2o")


def plan_units(p: int, rs) -> list:
    """Every unit and read a plan replays on a wave of ``p`` packets (those
    of ``integrator.loop_ops``, each bounce split where the skip rule reads
    ``any(lit)``: :meth:`FramePlan._run`), in an order a capture may
    follow: those on the frame-order buffers, the sort, those on the
    sorted ones, the end. The live prefix only shrinks, so at every rung
    after the first it fits one wave."""
    split = not integrator._shadow_always(rs)

    def bounce(s, b, primary):
        if not split:
            return [("step", s, b, primary)]
        return [("shade", s, b, primary), ("read", "lit", s, b, primary),
                ("light", s, b, primary, False), ("light", s, b, primary, True)]

    budget = integrator._loop_budget(p, rs)
    bounces = rs.max_bounce_count
    if not budget:
        return [("begin",), ("read", "live"), *bounce(0, p, True),
                *(bounce(0, p, False) if bounces else []), ("end",)]
    units = [("begin",), *bounce(0, p, True), ("sort",)]
    if bounces:
        units.append(("read", "neff"))
        for i, b in enumerate(integrator._loop_rungs(p, budget, rs)):
            n = p // b if i == 0 else 1
            if split:
                units += [u for s in range(0, n * b, b) for u in bounce(s, b, False)]
            else:
                units += [("iter", b, w) for w in range(1, n + 1)]
    return [*units, ("end",)]


def graphable(ts, rs, stats=None) -> bool:
    """Whether a frame of ``ts`` under ``rs`` replays a :class:`FramePlan`:
    a CUDA scene (one device: a sharded frame never comes here) that
    ``integrator.render_frame`` would render as one wave of the fused loop
    (``integrator.one_fused_wave``), with no ``stats``, no work counting,
    no validation and the kernel wrappers in place (``integrator.kernels``
    swaps them)."""
    if stats is not None or _build.counting_on() or rs.validation:
        return False
    if ts.device.type != "cuda" or integrator._KERNELS != integrator._DEFAULT_KERNELS:
        return False
    return integrator.one_fused_wave(ts, rs)


def capturer(device):
    """A function that captures a thunk's work on ``device`` into a CUDA
    graph -> ``(graph, the thunk's result)``. Its graphs share one memory
    pool, and capture on one side stream."""
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream(device)

    def capture(thunk):
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = thunk()
            finally:
                graph.capture_end()
        current.wait_stream(stream)
        return graph, out

    return capture


class _Unit(NamedTuple):
    graph: object     # replay()
    out: object       # what the unit returned while captured (static)
    launches: dict    # kernel -> launches captured


class FramePlan:
    """The CUDA graphs of one frame shape of one scene: made from the
    scene ``ts``, the render parameters ``rs`` and a camera tensor like
    the frames', it captures every unit at once (the raygen,
    :func:`plan_units`, the sky); :meth:`render` replays a frame.

    All the plan's graphs share one memory pool, and a frame replays only
    some of them, not in capture order: one ``("iter", b, n)`` an
    iteration, one of the two ``light`` units a wave. That is sound
    because each unit's outputs are consumed before any unit captured
    before it replays again: the frame-order buffers (raygen, ``begin``)
    by the sort, a shade unit's by its read and light units, a read's by
    the host, ``end``'s by the sky, the sky's by the detile. Memory a
    capture freed (the sort frees the frame-order buffers) may hold a
    later unit's outputs only under that rule."""

    def __init__(self, ts, rs, camera: torch.Tensor):
        dev = ts.device
        self.rs = rs
        self.ts = dataclasses.replace(
            ts, **{name: getattr(ts, name).clone() for name in REFRESHED})
        self.camera = camera.clone()
        spp = rs.samples_per_pixel
        (px, py), in_frame = integrator.tiled_pixels(rs, dev)
        self.frame_p = px.shape[0]
        self.p = self.frame_p * spp
        self.px, self.py, active, self.s_row = integrator._folded_rows(
            px, py, in_frame, spp)
        self.loop = integrator._FusedLoop(self.ts, rs, None, self.s_row, active)
        self.split = not integrator._shadow_always(rs)
        self.units = {}
        self._capture_fn = capturer(dev)
        for op in (("raygen",), *plan_units(self.p, rs), ("sky",)):
            self._capture(op)

    def fits(self, ts) -> bool:
        """Whether frames of ``ts`` may replay this plan: the same tables
        (the same tensor objects), the same other fields, and transforms of
        the same shapes."""
        for f in dataclasses.fields(ts):
            mine, theirs = getattr(self.ts, f.name), getattr(ts, f.name)
            if f.name in REFRESHED:
                if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
                    return False
            elif isinstance(mine, torch.Tensor) or isinstance(theirs, torch.Tensor):
                if mine is not theirs:
                    return False
            elif mine != theirs:
                return False
        return True

    def render(self, ts, camera: torch.Tensor) -> torch.Tensor:
        """The frame of ``ts`` (which :meth:`fits`) through ``camera`` ->
        (H, W, 3) f32, a new tensor. The spans lie as in an eager frame:
        the raygen before ``rt.loop``, the sky after it."""
        for name in REFRESHED:
            getattr(self.ts, name).copy_(getattr(ts, name))
        self.camera.copy_(camera)
        self._replay(("raygen",))
        with span("rt.loop"):
            integrator.drive(integrator.loop_ops(self.p, self.rs), self._run,
                             self._read)
        self._replay(("sky",))
        return integrator.detile(self.colors, self.rs)

    def _run(self, op) -> None:
        """Replay ``loop_ops``'s unit ``op``: where the skip rule reads
        ``any(lit)``, each bounce of a step as ``integrator._fused_step``
        runs it, its two halves with the read between. A unit past the
        first bounce (``integrator.later_unit``) replays inside an
        ``rt.later`` span, around its ``rt.graph.replay`` spans."""
        if integrator.later_unit(op):
            with span("rt.later"):
                self._replay_unit(op)
        else:
            self._replay_unit(op)

    def _replay_unit(self, op) -> None:
        if not self.split or op[0] not in ("step", "iter"):
            self._replay(op)
            return
        for s, b, primary in integrator._op_waves(op):
            self._replay(("shade", s, b, primary))
            lit = self._read(("read", "lit", s, b, primary))
            self._replay(("light", s, b, primary, bool(lit)))

    def _capture(self, op) -> _Unit:
        with span("rt.graph.capture"), _build.captured_launches() as launches:
            graph, out = self._capture_fn(lambda: self._enqueue(op))
        unit = self.units[op] = _Unit(graph, out, dict(launches))
        return unit

    def _replay(self, op):
        unit = self.units.get(op) or self._capture(op)
        with span("rt.graph.replay"):
            unit.graph.replay()
        _build.add_launches(unit.launches)
        return unit.out

    def _read(self, op):
        return integrator._read(self._replay(op), None)

    def _enqueue(self, op):
        """Enqueue unit ``op``'s work on the current stream -> its outputs
        (a read's reduction, a shade unit's outputs) or None."""
        rs, loop = self.rs, self.loop
        kind = op[0]
        if kind == "raygen":
            with span("rt.raygen"):
                loop.rays = integrator._KERNELS["raygen"](
                    self.camera, self.s_row, self.px, self.py,
                    rs.samples_per_pixel, rs.width, rs.height)
        elif kind == "sky":
            colors = integrator._deferred_sky(self.ts, rs, *loop.result, None)
            k = self.px.shape[1]
            spp = rs.samples_per_pixel
            self.colors = tuple(c.reshape(self.frame_p, spp, k).mean(dim=1)
                                for c in colors)
        elif kind == "read":
            return loop.reduction(op)
        else:
            return loop.run(op)
        return None


class FramePlans:
    """A renderer's :class:`FramePlan` per frame shape, at most
    :data:`MAX_PLANS`, the least recently used dropped first."""

    def __init__(self):
        self._plans = collections.OrderedDict()

    def render(self, ts, rs, camera: torch.Tensor, stats=None) -> torch.Tensor:
        """One frame -> (H, W, 3) f32: replayed from the shape's plan where
        :func:`graphable`, else ``integrator.render_frame``. A shape's first
        frame (or the first after its scene's tables changed) renders
        eagerly, then its plan is captured."""
        if not graphable(ts, rs, stats):
            return integrator.render_frame(ts, rs, camera, stats=stats)
        key = (ts.device, rs, tuple(camera.shape), camera.dtype)
        plan = self._plans.pop(key, None)
        if plan is not None and plan.fits(ts):
            img = plan.render(ts, camera)
        else:
            plan = None           # drop a stale plan before capturing anew
            img = integrator.render_frame(ts, rs, camera)
            plan = FramePlan(ts, rs, camera)
        self._plans[key] = plan
        while len(self._plans) > MAX_PLANS:
            self._plans.popitem(last=False)
        return img
