"""The share of the image's readbacks that lands in page-locked memory
(``metrics/frame.readback_pinned_pct.py``), read from traced frames made up
to the shape the profiler gives."""

from __future__ import annotations

import types

import pytest

from rtbench import manifest, profiling
from rtbench.tests.conftest import ROOT
from rtbench.tests.test_rtbench_profiling import IMAGE, Event


def readback_trace(copies):
    """A traced frame in which each of ``copies``, (destination, device ns,
    operand shape), is one host ``aten::copy_`` issuing one device-to-host
    memcpy into that destination."""
    out = [Event(profiling.WINDOW, 0, 10_000, activity="user_annotation")]
    for i, (dest, ns, shape) in enumerate(copies):
        t = 1000 * i
        out += [Event("aten::copy_", t, t + 900, shapes=(shape, shape)),
                Event("cudaMemcpyAsync", t + 10, t + 800, activity="cuda_runtime",
                      corr=10 + i),
                Event(f"Memcpy DtoH (Device -> {dest})", t + 100, t + 100 + ns,
                      activity="gpu_memcpy", corr=10 + i, device="CUDA")]
    return profiling.Trace(out, frames=1)


def readback_pinned_pct(copies):
    read = manifest.load_reader(ROOT / "rtbench" / "metrics" / "frame.readback_pinned_pct.py")
    return read(types.SimpleNamespace(trace=readback_trace(copies),
                                      image_shape=list(IMAGE)))


@pytest.mark.parametrize("copies, pct", [
    ([("Pinned", 300, IMAGE)], 100.0),
    ([("Pageable", 300, IMAGE)], 0.0),
    ([("Pinned", 100, IMAGE), ("Pageable", 300, IMAGE)], 25.0),
    # a copy of another shape (the loop's 4-byte read) is no image readback
    ([("Pinned", 100, IMAGE), ("Pageable", 400, (1,))], 100.0),
    ([("Pageable", 100, IMAGE), ("Pinned", 400, (1,))], 0.0),
], ids=["pinned", "pageable", "mixed", "pinned_beside_a_read", "pageable_beside_a_read"])
def test_readback_pinned_pct(copies, pct):
    assert readback_pinned_pct(copies) == pytest.approx(pct)


@pytest.mark.parametrize("copies", [[], [("Pinned", 400, (1,))]], ids=["none", "a_read"])
def test_readback_pinned_pct_reads_nothing_without_an_image_copy(copies):
    assert readback_pinned_pct(copies) is None
