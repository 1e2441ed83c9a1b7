"""The per-lane sweeps' record fetches per node visit
(``metrics/sweeps.fetch_pct.py``) on hand-made work counts: a known ratio
over both sweeps, and nothing where the program counts no fetches (a
program from before the pair walk) or no node visits."""

from __future__ import annotations

import types

import pytest

from rtbench import manifest
from rtbench.tests.conftest import ROOT

WORK = {
    "perlane_closest_sweep": {"nodes": 3000, "tests": 900, "fetches": 1600},
    "perlane_anyhit_sweep": {"nodes": 1000, "tests": 100, "fetches": 400},
    "mega_closest_sweep": {"nodes": 500, "tests": 90, "own_nodes": 400,
                           "own_tests": 80},
}


def read(work, monkeypatch):
    from raytpu_torch import _build

    monkeypatch.setattr(_build, "work_counts", lambda: work, raising=False)
    reader = manifest.load_reader(ROOT / "rtbench" / "metrics" / "sweeps.fetch_pct.py")
    return reader(types.SimpleNamespace(stats={"frames": 2}))


def test_fetches_over_visits_of_both_sweeps(monkeypatch):
    assert read(WORK, monkeypatch) == pytest.approx(100.0 * 2000 / 4000)


@pytest.mark.parametrize("sweeps", [("perlane_closest_sweep",), ("perlane_anyhit_sweep",)])
def test_one_sweep_alone(monkeypatch, sweeps):
    work = {k: WORK[k] for k in sweeps}
    want = 100.0 * sum(WORK[k]["fetches"] for k in sweeps) / sum(
        WORK[k]["nodes"] for k in sweeps)
    assert read(work, monkeypatch) == pytest.approx(want)


def test_a_program_without_fetches_reads_nothing(monkeypatch):
    from raytpu_torch import _build

    parent = {k: {key: n for key, n in w.items() if key != "fetches"}
              for k, w in WORK.items()}
    assert read(parent, monkeypatch) is None
    assert read({}, monkeypatch) is None
    monkeypatch.delattr(_build, "work_counts")
    reader = manifest.load_reader(ROOT / "rtbench" / "metrics" / "sweeps.fetch_pct.py")
    assert reader(types.SimpleNamespace(stats={"frames": 2})) is None


def test_no_node_visits_read_nothing(monkeypatch):
    zero = {k: dict.fromkeys(w, 0) for k, w in WORK.items()}
    assert read(zero, monkeypatch) is None
