"""One reader per metric, found by the metric's name: ``<name>.py`` holds
``read(ctx) -> float | None``. ``ctx`` (``portbench/run.py::Context``) holds
the window's calls, the traced run's summary (``portbench/trace.py``), the
configuration's sizes and the mix. A reader that finds nothing to read
returns None, and the metric is left out of the line."""

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = HERE / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no reader for metric {name!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
