"""The benchmark harness's tests of ``rtbench/tests/test_rtbench_fetch.py``, collected
with the repo's tests, beside the fixtures of ``rtbench/tests/conftest.py``."""

from rtbench.tests.conftest import few_threads, tiny_bench, tiny_cell  # noqa: F401
from rtbench.tests.test_rtbench_fetch import *  # noqa: F401,F403
