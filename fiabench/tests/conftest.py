"""Shared pieces of the benchmark's CPU tests: a spec over the real
``BENCHMARK.json`` whose configurations and traffic are cut to a size a
CPU test holds (every width and option as in the files)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fiabench.spec import Spec  # noqa: E402


class TinySpec(Spec):
    """The benchmark's cells at 60 users, 40 items, 1,500 rows, jobs of
    64 pairs in batches cut in the same ratio, a pool of 12 jobs."""

    def config(self, name):
        cfg = super().config(name)
        cfg.update(num_users=60, num_items=40, num_rows=1500)
        return cfg

    def traffic(self, name):
        tr = super().traffic(name)
        tr.update(job_queries=64, pool_jobs=12,
                  batch_queries=64 * tr["batch_queries"] // tr["job_queries"])
        return tr


@pytest.fixture(scope="session")
def spec():
    return Spec()


@pytest.fixture(scope="session")
def tiny():
    return TinySpec()
