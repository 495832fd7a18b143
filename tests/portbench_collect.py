"""Tier-1 runs ``portbench/tests``: one module under ``tests/`` per
``portbench/tests/test_*.py`` imports that file's tests (and this fixture),
so that the suite's unchanged command collects them and spreads them over
its workers file by file.

A benchmark run refuses to finish in a process that has loaded JAX or the
JAX package (``portbench/run.py::FORBIDDEN``), and this suite's
``conftest.py`` loads JAX in every worker. So here a run checks only the
modules that the test itself would bring in: those the worker had already
loaded are taken off the run's list for the test. The benchmark's own test
of what a run loads (``test_portbench_imports.py``) runs the harness in a
fresh interpreter, where the whole list holds."""

import sys

import pytest

from portbench import run


@pytest.fixture(autouse=True)
def jax_loaded_by_the_suite(monkeypatch):
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    monkeypatch.setattr(run, "FORBIDDEN", tuple(n for n in run.FORBIDDEN if n not in loaded))
