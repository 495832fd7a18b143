"""What a cell is made of, found by the names in ``BENCHMARK.json``.

* ``configs/<file>``: the model configuration as published (its ``config.json``
  keys at the top level), the port's registry entry and the fields set on it,
  the terminators, the weight scheme and the precisions the run states, and
  under ``port.architecture`` the module of ``arch/`` that builds it
  (``dense`` without the key).
* ``traffic/<traffic>.json``: the mix (one round of calls, each the prompt
  lengths of its lanes, from the benchmark named in ``source``; new tokens;
  the cache) and the sample the check takes.
* ``limits/<workload>.json``: the limit of each number the check compares.
* ``metrics/<metric>.py``: one reader per metric.

Nothing here imports the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from .arch import of as architecture_of

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def arch(self):
        """The architecture module the configuration names (``arch/``)."""
        return architecture_of(self.config)

    @property
    def dims(self):
        return self.arch.dims(self.config)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell_name: str, e2e_names) -> bool:
    """Whether a metric is reported in this cell: listed there, or, without
    a ``workloads`` key, in every cell that reports what it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"] if applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(work["chips"]), config_name=conf["name"],
        config=load_json(ROOT / conf["file"]), traffic_name=work["traffic"],
        traffic=load_json(HERE / "traffic" / f"{work['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer,
    )
