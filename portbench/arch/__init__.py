"""Architectures: one module per model family, named by a configuration.

A configuration file chooses its module with ``port.architecture`` (the
file ``arch/<name>.py``); without the key it is ``dense``. The harness
(``run.py``, ``check.py``, ``calibrate.py``) and every reader under
``metrics/`` reach the model only through these names, which every
architecture module gives:

* ``dims(doc) -> dims``: the sizes the harness needs, from the
  configuration file (the published keys at the top level, ``port`` below);
  ``dims.n_layer``, ``dims.vocab`` and ``dims.group_size`` at least;
* ``port_config(cell)``: the program's ``ModelConfig`` for the cell,
  checked against the published keys (raises where they differ);
* ``make_weights(dims, seed, device)``: the program's parameter tree, drawn
  from the seed on the device, the same for the same seed;
  ``weight_bytes(dims)``: the bytes of its int4 leaves;
* ``Reference(dims, weights, cache_doc, checked)``: the plain reference,
  with ``follow(prompts, served, choices=None)`` and ``control(on=True)``
  as ``check.judge`` uses them (``reference/model.py``), reading the
  cache of layer ``checked``;
* ``checked_layer(dims)``: the layer whose cache the run keeps after the
  last call and the check compares with the reference's: one that holds
  the cache policy under test;
* ``cache_kwargs(cache_doc, cfg)``: the cache arguments of
  ``runtime.engine.build_cache_specs`` for the mix's ``cache`` on the
  program's ``ModelConfig`` ``cfg``;
* the work counts the readers use (``roofline.Work`` or least seconds at
  the card's peaks): ``decode_step(dims, B, C, bits)`` and
  ``prefill(dims, lengths)`` (whole step, whole prefill);
  ``decode_gemv_seconds(dims, B)``, ``decode_attention_seconds(dims, B, C,
  bits)`` and ``prefill_attention_seconds(dims, lengths)`` (every layer of
  one step or one prefill, each operation at its own bound). A module
  leaves out the count of a kernel its architecture lacks, and that
  kernel's reader returns None.

``load(name)`` finds the module by its file name, as ``metrics`` finds
readers, so that a new architecture arrives as an added file, and refuses
one that lacks a name of ``REQUIRED``.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEFAULT = "dense"
#: The names every architecture module gives; the per-kernel counts are
#: optional.
REQUIRED = ("dims", "port_config", "make_weights", "weight_bytes", "Reference",
            "checked_layer", "cache_kwargs", "decode_step", "prefill")


def load(name: str = DEFAULT):
    """The architecture module ``arch/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not (HERE / f"{name}.py").exists():
        raise SystemExit(f"no architecture module {name!r} under {HERE}")
    module = importlib.import_module(f"{__name__}.{name}")
    missing = [n for n in REQUIRED if not hasattr(module, n)]
    if missing:
        raise SystemExit(f"architecture module {name!r} lacks {', '.join(missing)}")
    return module


def of(config: dict):
    """The architecture module a configuration file names."""
    return load(config.get("port", {}).get("architecture", DEFAULT))
