"""Tier-1 collects ``portbench/tests/test_portbench_run.py`` (``tests/portbench_collect.py``)."""

from portbench.tests.test_portbench_run import *  # noqa: F401,F403
from portbench_collect import jax_loaded_by_the_suite  # noqa: F401  (autouse)
