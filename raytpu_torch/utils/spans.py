"""Named spans of the frame's phases, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler session is active, and one shared no-op context otherwise. The
profiler (Kineto) records the spans as host events in the same trace as
the device's kernels and copies, on the same clock; a span's parent is the
span it nests in. Nothing else turns them on: wrap the viewer in
``torch.profiler.profile(activities=[CPU, CUDA])`` to get them.

The gate is the profiler module's flag, which a session sets for every
thread: with no profiler running an ungated ``record_function`` costs
about 12 us on one x86-64 core, the flag test about 0.03 us (the C call
``torch._C._autograd._profiler_enabled()`` 0.15 us, and it reads false
under ``profile_all_threads``). A default session records the
thread that started it; the slot threads of a sharded frame
(``parallel/dist.py``) record only under
``experimental_config=torch.profiler._ExperimentalConfig(profile_all_threads=True)``.

The names, from the outside in (``rtbench/`` reads them):

* ``rt.step`` (``Renderer.step``), ``rt.set_transforms``, ``rt.render``,
  ``rt.readback`` (the image's copy to the host in ``render_np``);
* per wave ``rt.raygen``, then ``rt.loop`` (the bounce loop, from its
  buffers up to the sky) holding ``rt.bounce`` (one bounce) and
  ``rt.sort`` (the live-first sort and its inverse); then ``rt.sky``;
* in a bounce ``rt.sweep.closest`` and ``rt.sweep.shadow``, each holding
  ``rt.prepass`` on the culled tiers, and ``rt.shade``, ``rt.accumulate``
  (K3, K4);
* ``rt.sync``: each counted host sync (``integrator._read``);
* ``rt.later``: each unit of the loop past the first bounce
  (``integrator.later_unit``: a compacted iteration's waves, or a bounce
  after the first), eager or replayed; a replayed unit's ``rt.graph.replay``
  spans lie inside it;
* ``rt.detile``;
* ``rt.graph.capture`` (each unit a frame plan captures, ``graphs.py``)
  and ``rt.graph.replay`` (each replay of one): a replayed frame shows the
  raygen's replay, then ``rt.loop`` holding the loop's replays and its
  ``rt.sync`` reads over the eager loop's stretch, then the sky's replay;
  none of the spans that the captured work records (``rt.prepass``,
  ``rt.sweep.*``, ``rt.shade``, ``rt.accumulate``): that work runs inside
  the replays.
"""

from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profiler session
    is active; the shared no-op context otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function is a :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
