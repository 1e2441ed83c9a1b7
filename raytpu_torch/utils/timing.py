"""Frame timing and throughput meters of the port (counterpart of
``raytpu/utils/timing.py``).

The reference's only instrumentation is a 1-second-window FPS print gated
by ``TEST_FPS`` (``src/main.cpp:65-81,2969-2971``); :class:`FpsCounter`
keeps it. :class:`StageTimes` and :func:`measure_frame` add per-stage and
per-frame timers and :func:`mrays_per_sec` the Mrays/s meter.

Which clock: every number here is the host's ``time.perf_counter`` around
work that ends in :func:`block_until_ready`, which is
``torch.cuda.synchronize`` on the card of the result (nothing for a CPU
tensor, whose eager ops are done when they return), and for a sharded
frame in :func:`synchronize` of every card it used (``Renderer.devices``). That is wall time
with the device drained: what a viewer waits for a frame, host issue and
the frame's own host syncs included, not the device's busy time (which
only a profiler reads). Kernel times come from a profiler around the
frames, whose trace holds the ``rt.*`` spans of :mod:`raytpu_torch.utils.spans`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch


def block_until_ready(out):
    """Wait until the device work that produces the tensor ``out`` is done
    (``jax.block_until_ready``'s counterpart): synchronize its card; a CPU
    tensor or a non-tensor needs nothing. Returns ``out``."""
    dev = getattr(out, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def synchronize(devices) -> None:
    """Wait until every CUDA device of ``devices`` is done: the cards of a
    sharded frame, each of which ran its own slots' work (the result's
    card alone does not say that the others finished)."""
    for dev in dict.fromkeys(map(torch.device, devices)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class FpsCounter:
    """1-second-window FPS print (``src/main.cpp:65-81``)."""

    def __init__(self, print_fn=print):
        self._frames = 0
        self._window_start = None
        self._print = print_fn
        self.last_fps: Optional[float] = None

    def frame(self) -> Optional[float]:
        now = time.perf_counter()
        if self._window_start is None:
            self._window_start = now
        self._frames += 1
        elapsed = now - self._window_start
        if elapsed >= 1.0:
            self.last_fps = self._frames / elapsed
            self._print(f"FPS: {self.last_fps:.1f}")
            self._frames = 0
            self._window_start = now
            return self.last_fps
        return None


@dataclasses.dataclass
class StageTimes:
    """Accumulated per-stage wall times (build / trace / shade / total)."""

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        """Time a stage; pass ``block``, a tensor (or a callable returning
        one), to end the stage with :func:`block_until_ready` on it, so
        that the time includes the device's work."""
        t0 = time.perf_counter()
        yield
        if block is not None:
            block_until_ready(block() if callable(block) else block)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        return " | ".join(
            f"{k}: {self.mean(k) * 1e3:.1f} ms" for k in sorted(self.totals)
        )


def mrays_per_sec(num_rays: int, seconds: float) -> float:
    return num_rays / max(seconds, 1e-12) / 1e6


def measure_frame(render_fn, *args, warmup: int = 1, iters: int = 5,
                  pipelined: bool = True, devices=()):
    """Time ``render_fn(*args)``, which returns a tensor, on the host clock
    with the device drained, and every CUDA device of ``devices`` (see the
    module docstring). Returns
    ``(mean_seconds, per-iteration list)``; in pipelined mode the list has
    one entry, the mean, since enqueue-all/block-once has no per-iteration
    resolution.

    ``pipelined`` (default) enqueues every iteration and blocks once. A
    port frame still waits on the host inside itself, for each counted
    host read (the live prefix ``n_eff`` of every bounce and the
    shadow-skip ``any(lit)``), so its frames overlap little. With
    ``pipelined=False`` every frame blocks: strict call-return latency."""
    for _ in range(warmup):
        block_until_ready(render_fn(*args))
        synchronize(devices)
    if pipelined:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = render_fn(*args)
        block_until_ready(out)
        synchronize(devices)
        total = time.perf_counter() - t0
        return total / iters, [total / iters]
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(render_fn(*args))
        synchronize(devices)
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times), times
