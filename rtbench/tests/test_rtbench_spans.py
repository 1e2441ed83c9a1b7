"""The readers of the program's spans, on events made up to the shape the
profiler gives: interval arithmetic, device idle inside ``rt.step`` and
outside ``rt.loop`` or inside it, the PyTorch kernels launched inside
``rt.prepass`` (matched through the runtime call that issued them), the
sweeps' roofline from the work counters, and nothing from a trace without
spans."""

from __future__ import annotations

import types

import pytest

from rtbench import manifest, profiling, spans
from rtbench.tests.conftest import ROOT
from rtbench.tests.test_rtbench_profiling import Event

GPU = dict(device="CUDA")
SPAN = dict(activity="user_annotation")


def kernel(name, start, end, corr):
    return Event(name, start, end, activity="kernel", corr=corr, **GPU)


def launch(start, corr):
    return Event("cudaLaunchKernel", start, start + 5, activity="cuda_runtime", corr=corr)


def events(with_spans=True):
    """Two frames of 1000 ns. Frame 0: a step [0, 900) holding a loop
    [100, 700) with a prepass [150, 300); the prepass launches a PyTorch
    kernel (device [320, 380)) and K7 (device [380, 420)), the loop a
    sweep after it (device [500, 600)). Frame 1: a step [1000, 1500) with
    no loop and one kernel (device [1100, 1200))."""
    out = [Event(profiling.WINDOW, 0, 2000, **SPAN),
           Event(profiling.FRAME, 0, 950, **SPAN),
           Event(profiling.FRAME, 1000, 1950, **SPAN)]
    if with_spans:
        out += [Event("rt.step", 0, 900, **SPAN), Event("rt.loop", 100, 700, **SPAN),
                Event("rt.prepass", 150, 300, **SPAN),
                Event("rt.step", 1000, 1500, **SPAN)]
    out += [launch(160, 1), launch(200, 2), launch(400, 3), launch(1050, 4),
            kernel("void at::native::index_elementwise_kernel<F>(F)", 320, 380, 1),
            kernel("(anonymous namespace)::block_stats_kernel(float const*)", 380, 420, 2),
            kernel("void (anonymous namespace)::perlane_closest_sweep_kernel<false>"
                   "(float const*)", 500, 600, 3),
            kernel("void at::native::reduce_kernel<F>(F)", 1100, 1200, 4)]
    return out


def ctx_of(trace, stats=None, ops_per_s=0.0):
    return types.SimpleNamespace(trace=trace, stats=stats or {"frames": trace.frames},
                                 ops_per_s=ops_per_s,
                                 port_kernels={"block_stats_kernel",
                                               "perlane_closest_sweep_kernel",
                                               "perlane_anyhit_sweep_kernel"})


def reader(name):
    return manifest.load_reader(ROOT / "rtbench" / "metrics" / f"{name}.py")


def test_interval_arithmetic():
    a = spans.union([(5, 9), (0, 3), (2, 4), (9, 10)])
    assert a == [(0, 4), (5, 10)]
    assert spans.intersect(a, [(3, 6), (8, 20)]) == [(3, 4), (5, 6), (8, 10)]
    assert spans.subtract(a, [(1, 2), (6, 7), (9, 30)]) == [(0, 1), (2, 4), (5, 6), (7, 9)]
    assert spans.length_ns(a) == 9


def test_idle_inside_the_step_and_the_loop():
    tr = profiling.Trace(events(), frames=2)
    assert spans.spans(tr, "rt.step") == [(0, 900), (1000, 1500)]
    assert spans.idle(tr) == [(0, 320), (420, 500), (600, 1100), (1200, 2000)]
    # idle in the loop [100, 700): [100, 320) + [420, 500) + [600, 700)
    assert reader("loop.idle_ms")(ctx_of(tr)) == pytest.approx(400e-6 / 2)
    # in the steps, out of the loop: [0, 100) + [700, 900) + [1000, 1100) + [1200, 1500)
    assert reader("frame.idle_ms")(ctx_of(tr)) == pytest.approx(700e-6 / 2)


def test_the_prepass_kernels_are_matched_by_their_launch():
    tr = profiling.Trace(events(), frames=2)
    issued = spans.issued_inside(tr, "rt.prepass")
    assert [d.start for d in issued] == [320, 380]   # launched at 160 and 200
    # the PyTorch kernel only: K7 is one of the port's kernels
    assert reader("prepass.torch_ops_ms")(ctx_of(tr)) == pytest.approx(60e-6 / 2)


def test_the_sweeps_roofline_reads_the_work_counters(monkeypatch):
    from raytpu_torch import _build

    tr = profiling.Trace(events(), frames=2)
    work = {"perlane_closest_sweep": {"nodes": 1000, "tests": 200},
            "perlane_anyhit_sweep": {"nodes": 0, "tests": 0}}
    monkeypatch.setattr(_build, "work_counts", lambda: work, raising=False)
    read = reader("sweeps.roofline_pct")
    ops = 1000 * 23 + 200 * 51
    # least time: ops / 1e12 s over 2 frames; the sweep: 100 ns over 2 frames
    got = read(ctx_of(tr, ops_per_s=1e12))
    assert got == pytest.approx(100.0 * (ops / 1e12 / 2) / (100e-9 / 2))
    assert read(ctx_of(tr, ops_per_s=0.0)) is None
    monkeypatch.delattr(_build, "work_counts")
    assert read(ctx_of(tr, ops_per_s=1e12)) is None


def test_a_trace_without_spans_reads_nothing():
    tr = profiling.Trace(events(with_spans=False), frames=2)
    for name in ("frame.idle_ms", "loop.idle_ms", "prepass.torch_ops_ms"):
        assert reader(name)(ctx_of(tr)) is None, name
