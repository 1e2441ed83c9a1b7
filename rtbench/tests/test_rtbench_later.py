"""The readers of the consensus sweeps' later waves
(``consensus.later_ms``, ``consensus.later_roofline_pct``,
``consensus.later_useful_pct``) on events made up to the shape the
profiler gives and on hand-made work counts: K8 and K9 launched inside
the program's ``rt.later`` spans, eagerly or by a graph's replay, count;
those launched outside, and other kernels inside, do not; each reader
reads nothing where the program has no later entries."""

from __future__ import annotations

import types

import pytest

from rtbench import manifest, profiling
from rtbench.tests.conftest import ROOT
from rtbench.tests.test_rtbench_profiling import Event
from rtbench.tests.test_rtbench_spans import SPAN, kernel

K8 = "void (anonymous namespace)::mega_closest_sweep_kernel<true>(float const*)"
K9 = "void (anonymous namespace)::mega_anyhit_sweep_kernel<false>(float const*)"


def call(name, start, corr):
    return Event(name, start, start + 5, activity="cuda_runtime", corr=corr)


def events(with_spans=True):
    """Two frames of 1000 ns. Frame 0, eager: K8 launched at 100 before any
    ``rt.later`` (device [150, 250)); inside ``rt.later`` [300, 600) K8
    (launched at 350, device [400, 520)), K9 (450, [520, 560)) and a
    PyTorch kernel (500, [560, 600)). Frame 1, replayed: inside
    ``rt.later`` [1300, 1700) one graph launch at 1350 runs K8 [1400,
    1480) and K9 [1480, 1500); K8 launched at 1800, outside, runs [1820,
    1900)."""
    out = [Event(profiling.WINDOW, 0, 2000, **SPAN),
           Event(profiling.FRAME, 0, 950, **SPAN),
           Event(profiling.FRAME, 1000, 1950, **SPAN)]
    if with_spans:
        out += [Event("rt.later", 300, 600, **SPAN), Event("rt.later", 1300, 1700, **SPAN),
                Event("rt.graph.replay", 1340, 1370, **SPAN)]
    out += [call("cudaLaunchKernel", 100, 1), kernel(K8, 150, 250, 1),
            call("cudaLaunchKernel", 350, 2), kernel(K8, 400, 520, 2),
            call("cudaLaunchKernel", 450, 3), kernel(K9, 520, 560, 3),
            call("cudaLaunchKernel", 500, 4),
            kernel("void at::native::reduce_kernel<F>(F)", 560, 600, 4),
            call("cudaGraphLaunch", 1350, 5), kernel(K8, 1400, 1480, 5),
            kernel(K9, 1480, 1500, 5),
            call("cudaLaunchKernel", 1800, 6), kernel(K8, 1820, 1900, 6)]
    return out


# later ns: K8 120 + K9 40 eagerly, K8 80 + K9 20 replayed, over 2 frames
LATER_MS = (120 + 40 + 80 + 20) * 1e-6 / 2
WORK = {
    "perlane_closest_sweep": {"nodes": 7, "tests": 3},
    "perlane_anyhit_sweep": {"nodes": 0, "tests": 0},
    "mega_closest_sweep": {"nodes": 3000, "tests": 900, "own_nodes": 2000, "own_tests": 400},
    "mega_anyhit_sweep": {"nodes": 300, "tests": 0, "own_nodes": 300, "own_tests": 0},
    "mega_closest_sweep.later": {"nodes": 1000, "tests": 400, "own_nodes": 600,
                                 "own_tests": 100},
    "mega_anyhit_sweep.later": {"nodes": 200, "tests": 0, "own_nodes": 200,
                                "own_tests": 0},
}
OWN = 800 * 23 + 100 * 51
MADE = 1200 * 23 + 400 * 51


def reader(name):
    return manifest.load_reader(ROOT / "rtbench" / "metrics" / f"{name}.py")


def ctx_of(trace, ops_per_s=1e12):
    return types.SimpleNamespace(trace=trace, stats={"frames": trace.frames},
                                 ops_per_s=ops_per_s)


@pytest.fixture
def work(monkeypatch):
    from raytpu_torch import _build

    counts = {k: dict(v) for k, v in WORK.items()}
    monkeypatch.setattr(_build, "work_counts", lambda: counts, raising=False)
    return counts


def test_later_ms_counts_the_sweeps_launched_inside_rt_later(work):
    tr = profiling.Trace(events(), frames=2)
    assert reader("consensus.later_ms")(ctx_of(tr)) == pytest.approx(LATER_MS)


def test_later_roofline_is_the_own_work_over_the_later_time(work):
    tr = profiling.Trace(events(), frames=2)
    read = reader("consensus.later_roofline_pct")
    least_ms = OWN / 1e12 * 1e3 / 2
    assert read(ctx_of(tr)) == pytest.approx(100.0 * least_ms / LATER_MS)
    assert read(ctx_of(tr, ops_per_s=0.0)) is None


def test_later_useful_is_the_own_share_of_the_later_work(work):
    tr = profiling.Trace(events(), frames=2)
    assert reader("consensus.later_useful_pct")(ctx_of(tr)) == pytest.approx(
        100.0 * OWN / MADE)


@pytest.mark.parametrize("name", ["later_ms", "later_roofline_pct", "later_useful_pct"])
def test_a_program_without_later_entries_reads_nothing(work, name, monkeypatch):
    from raytpu_torch import _build

    tr = profiling.Trace(events(), frames=2)
    read = reader(f"consensus.{name}")
    for k in ("mega_closest_sweep.later", "mega_anyhit_sweep.later"):
        del work[k]
    assert read(ctx_of(tr)) is None
    monkeypatch.delattr(_build, "work_counts")
    assert read(ctx_of(tr)) is None


@pytest.mark.parametrize("name", ["later_ms", "later_roofline_pct"])
def test_a_trace_without_rt_later_reads_no_time(work, name):
    tr = profiling.Trace(events(with_spans=False), frames=2)
    assert reader(f"consensus.{name}")(ctx_of(tr)) is None


def test_no_later_work_reads_no_share(work):
    for k in ("mega_closest_sweep.later", "mega_anyhit_sweep.later"):
        work[k] = dict.fromkeys(work[k], 0)
    tr = profiling.Trace(events(), frames=2)
    assert reader("consensus.later_useful_pct")(ctx_of(tr)) is None
    assert reader("consensus.later_roofline_pct")(ctx_of(tr)) is None
