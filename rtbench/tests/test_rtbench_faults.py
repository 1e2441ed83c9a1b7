"""A run with the timed path broken underneath comes out not correct:
once for each fault a viewer's frame can have. The harness's look for a
card is skipped; the rest of a run is driven on the CPU at a tiny
size, three loops of eight poses."""

from __future__ import annotations

import pytest

from raytpu_torch import integrator
from raytpu_torch.render import Renderer
from rtbench import run


def stale(monkeypatch):
    """A step that returns its state unchanged: the previous frame."""
    step = Renderer.step
    last = {}

    def stale_step(self, time_param):
        img = step(self, time_param)
        prev = last.get("img", img)
        last["img"] = img
        return prev
    monkeypatch.setattr(Renderer, "step", stale_step)


def half_batch(monkeypatch):
    """Half of each pixel's samples left out, the mean taken over the rest
    (the folded wave holds tile t's sample s at packet t * spp + s)."""
    trace_wave = integrator._trace_wave

    def half(ts, rs, camera, px, py, act, s_row, rays6, stats):
        colors = trace_wave(ts, rs, camera, px, py, act, s_row, rays6, stats)
        spp = rs.samples_per_pixel
        out = []
        for c in colors:
            c = c.reshape(c.shape[0] // spp, spp, -1).clone()
            c[:, spp // 2:] = c[:, :spp - spp // 2]
            out.append(c.reshape(-1, c.shape[-1]))
        return tuple(out)
    monkeypatch.setattr(integrator, "_trace_wave", half)


def altered(monkeypatch):
    """An answer altered where it is produced: every 16th lane of each
    wave (the same pixels in every sample) comes out 0.1 redder."""
    trace_wave = integrator._trace_wave

    def alter(*args):
        r, g, b = trace_wave(*args)
        r = r.clone()
        r.view(-1)[::16] += 0.1
        return r, g, b
    monkeypatch.setattr(integrator, "_trace_wave", alter)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    from rtbench import manifest
    from rtbench.tests.conftest import make_tiny_bench

    bench = make_tiny_bench(tmp_path_factory.mktemp("faults"), loop=8)
    return manifest.Cell(manifest.load(bench.parent / "BENCHMARK.json"),
                         "config4.closeup", bench)


def _run(cell):
    return run.run_cell(cell, 2**31 + 77, 0.0, False, "cpu", min_loops=3,
                        log=lambda m: None)["result"]


def test_the_unbroken_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["check"]


@pytest.mark.parametrize("fault", [stale, half_batch, altered],
                         ids=lambda f: f.__name__)
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"], result["check"]
    assert result["failed"] >= 1
