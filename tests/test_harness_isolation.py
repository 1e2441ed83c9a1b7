"""The benchmark harness's tests of ``rtbench/tests/test_rtbench_isolation.py``,
collected with the repo's tests, beside the fixtures of ``rtbench/tests/conftest.py``.

The harness runs in a process that loads no JAX; this one has it loaded
(``tests/conftest.py`` pins JAX to the CPU), so each test here runs with
the JAX modules out of ``sys.modules`` and gets them back after."""

import sys

import pytest

from rtbench.tests.conftest import few_threads, tiny_bench, tiny_cell  # noqa: F401
from rtbench.tests.test_rtbench_isolation import *  # noqa: F401,F403


@pytest.fixture(autouse=True)
def harness_process_without_jax(monkeypatch):
    from rtbench import run

    for name in [m for m in sys.modules if m.split(".", 1)[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
