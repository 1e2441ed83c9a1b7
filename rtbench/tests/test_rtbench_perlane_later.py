"""The readers of the per-lane sweeps' later waves (``sweeps.later_ms``,
``sweeps.later_roofline_pct``) on events made up to the shape the
profiler gives and on hand-made work counts: K1 and K2 launched inside
the program's ``rt.later`` spans, eagerly or by a graph's replay, count;
those launched outside, and other kernels inside (K8 among them), do
not; each reader reads nothing where the program has no per-lane later
entries or the trace no ``rt.later`` span."""

from __future__ import annotations

import pytest

from rtbench import profiling
from rtbench.tests.test_rtbench_later import call, ctx_of, reader
from rtbench.tests.test_rtbench_profiling import Event
from rtbench.tests.test_rtbench_spans import SPAN, kernel

K1 = "void (anonymous namespace)::perlane_closest_sweep_kernel<true>(float const*)"
K2 = "void (anonymous namespace)::perlane_anyhit_sweep_kernel<false>(float const*)"
K8 = "void (anonymous namespace)::mega_closest_sweep_kernel<false>(float const*)"
NAMES = ("later_ms", "later_roofline_pct")
COUNTED = ("perlane_closest_sweep.later", "perlane_anyhit_sweep.later")


def events(with_spans=True):
    """Two frames of 1000 ns. Frame 0, eager: K1 launched at 100 before any
    ``rt.later`` (device [150, 250)); inside ``rt.later`` [300, 600) K1
    (launched at 350, device [400, 530)), K2 (450, [530, 560)) and K8
    (500, [560, 600)). Frame 1, replayed: inside ``rt.later`` [1300, 1700)
    one graph launch at 1350 runs K1 [1400, 1490) and K2 [1490, 1500); K1
    launched at 1800, outside, runs [1820, 1900)."""
    out = [Event(profiling.WINDOW, 0, 2000, **SPAN),
           Event(profiling.FRAME, 0, 950, **SPAN),
           Event(profiling.FRAME, 1000, 1950, **SPAN)]
    if with_spans:
        out += [Event("rt.later", 300, 600, **SPAN), Event("rt.later", 1300, 1700, **SPAN),
                Event("rt.graph.replay", 1340, 1370, **SPAN)]
    out += [call("cudaLaunchKernel", 100, 1), kernel(K1, 150, 250, 1),
            call("cudaLaunchKernel", 350, 2), kernel(K1, 400, 530, 2),
            call("cudaLaunchKernel", 450, 3), kernel(K2, 530, 560, 3),
            call("cudaLaunchKernel", 500, 4), kernel(K8, 560, 600, 4),
            call("cudaGraphLaunch", 1350, 5), kernel(K1, 1400, 1490, 5),
            kernel(K2, 1490, 1500, 5),
            call("cudaLaunchKernel", 1800, 6), kernel(K1, 1820, 1900, 6)]
    return out


# later ns: K1 130 + K2 30 eagerly, K1 90 + K2 10 replayed, over 2 frames
LATER_MS = (130 + 30 + 90 + 10) * 1e-6 / 2
WORK = {
    "perlane_closest_sweep": {"nodes": 9000, "tests": 3000, "fetches": 4800},
    "perlane_anyhit_sweep": {"nodes": 600, "tests": 100, "fetches": 320},
    "mega_closest_sweep": {"nodes": 5, "tests": 2, "own_nodes": 5, "own_tests": 2},
    "mega_anyhit_sweep": {"nodes": 0, "tests": 0, "own_nodes": 0, "own_tests": 0},
    "perlane_closest_sweep.later": {"nodes": 4000, "tests": 1500, "fetches": 2100},
    "perlane_anyhit_sweep.later": {"nodes": 200, "tests": 40, "fetches": 110},
    "mega_closest_sweep.later": {"nodes": 5, "tests": 2, "own_nodes": 5, "own_tests": 2},
    "mega_anyhit_sweep.later": {"nodes": 0, "tests": 0, "own_nodes": 0, "own_tests": 0},
}
OPS = 4200 * 23 + 1540 * 51


@pytest.fixture
def work(monkeypatch):
    from raytpu_torch import _build

    counts = {k: dict(v) for k, v in WORK.items()}
    monkeypatch.setattr(_build, "work_counts", lambda: counts, raising=False)
    return counts


def test_later_ms_counts_k1_and_k2_launched_inside_rt_later(work):
    tr = profiling.Trace(events(), frames=2)
    assert reader("sweeps.later_ms")(ctx_of(tr)) == pytest.approx(LATER_MS)


def test_later_roofline_is_the_later_work_over_the_later_time(work):
    tr = profiling.Trace(events(), frames=2)
    read = reader("sweeps.later_roofline_pct")
    least_ms = OPS / 1e12 * 1e3 / 2
    assert read(ctx_of(tr)) == pytest.approx(100.0 * least_ms / LATER_MS)
    assert read(ctx_of(tr, ops_per_s=0.0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_perlane_later_entries_reads_nothing(work, name, monkeypatch):
    """The parent commit's counts: K8/K9 later entries, none for K1/K2."""
    from raytpu_torch import _build

    tr = profiling.Trace(events(), frames=2)
    read = reader(f"sweeps.{name}")
    for k in COUNTED:
        del work[k]
    assert read(ctx_of(tr)) is None
    monkeypatch.delattr(_build, "work_counts")
    assert read(ctx_of(tr)) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_trace_without_rt_later_reads_no_time(work, name):
    tr = profiling.Trace(events(with_spans=False), frames=2)
    assert reader(f"sweeps.{name}")(ctx_of(tr)) is None


def test_no_later_work_reads_no_share(work):
    for k in COUNTED:
        work[k] = dict.fromkeys(work[k], 0)
    tr = profiling.Trace(events(), frames=2)
    assert reader("sweeps.later_roofline_pct")(ctx_of(tr)) is None
    assert reader("sweeps.later_ms")(ctx_of(tr)) == pytest.approx(LATER_MS)
