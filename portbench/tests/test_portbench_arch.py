"""Architecture modules: a new one arrives as added files alone, and
``dense`` makes what the harness made before it was a module."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import arch, run, spec
from portbench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(tree) -> str:
    """sha256 over a parameter tree: keys in order, each tensor's dtype,
    shape and bytes, every other leaf's repr."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                walk(x[k])
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            h.update(str(x.dtype).encode())
            h.update(str(tuple(x.shape)).encode())
            h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())

    walk(tree)
    return h.hexdigest()


#: The tiny cells at seed 0 as the harness read them before the dense code
#: became ``arch/dense.py``: the weights' digest and the check's readings.
PINNED = {
    1: ("48ffe8310b1d60b9cb88d3eb2ff8484a329214314f6d1e29f1bf6795111e6080",
        {"kv_rel_err_l0": 0.0, "pos_miss_l0": 0.0, "mean_logp_err": 1.3764324312425123e-07,
         "max_logp_err": 4.2931782573418786e-07, "max_logit_gap": 0.0,
         "first_prob_rel_err": 2.142300541407849e-07}),
    4: ("2f2113677a21fdb2cb6b93b660cde152aaab2adb47127c91592ab9f358090dc7",
        {"kv_rel_err_l0": 0.0, "pos_miss_l0": 0.0, "mean_logp_err": 1.0902999732683345e-07,
         "max_logp_err": 2.988010141535824e-07, "max_logit_gap": 0.0,
         "first_prob_rel_err": 2.2305039193426524e-07}),
}


@pytest.mark.parametrize("batch", [1, 4])
def test_dense_makes_what_the_harness_made_before(batch):
    cell = tiny.cell(batch=batch, bias=batch > 1)
    assert cell.arch is arch.load("dense")
    want_digest, want = PINNED[batch]
    assert digest(cell.arch.make_weights(cell.dims, 0, "cpu")) == want_digest
    r = run.run_cell(cell, 0, 0.0, False, device="cpu")
    assert r["correct"]
    assert {**{k: c["value"] for k, c in r["checks"].items()}, **r["readings"]} == want


def test_unknown_architecture_is_refused():
    for name in ("no_such_arch", "../run", "dense.py"):
        with pytest.raises(SystemExit):
            arch.load(name)


def test_an_architecture_that_lacks_a_name_is_refused(tmp_path, monkeypatch):
    """``load`` names what an architecture module lacks of ``REQUIRED``."""
    (tmp_path / "thin.py").write_text("from portbench.arch.dense import dims, Reference\n")
    monkeypatch.setattr(arch, "HERE", tmp_path)
    monkeypatch.setattr(arch, "__path__", [str(tmp_path)])
    monkeypatch.delitem(sys.modules, "portbench.arch.thin", raising=False)
    with pytest.raises(SystemExit, match="lacks port_config, make_weights"):
        arch.load("thin")
    sys.modules.pop("portbench.arch.thin", None)


@pytest.mark.parametrize("checked", [-1, 2])
def test_the_checked_layer_is_one_of_the_models(checked):
    cell = tiny.cell()
    a = cell.arch
    with pytest.raises(ValueError, match="not one of the model's 2 layers"):
        a.Reference(cell.dims, a.make_weights(cell.dims, 0, "cpu"), cell.traffic["cache"],
                    checked=checked)


PROBE = '''"""A probe architecture: ``dense``, with a reference of its own and the
second layer checked."""

from portbench.arch import dense
from portbench.arch.dense import *  # noqa: F401,F403

USED = []
FAULT = False


def make_weights(d, seed, device):
    USED.append("make_weights")
    return dense.make_weights(d, seed, device)


def checked_layer(d):
    return 1


class Reference(dense.Reference):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        USED.append(f"Reference checked {self.checked}")

    def _ffn(self, L, x, bits):
        """With FAULT, the first layer's FFN output doubled: the second
        layer's K and V rows change, the first layer's do not."""
        y = super()._ffn(L, x, bits)
        return y * 2 if FAULT and L is self.layers[0] else y
'''

RUN_PROBE = """
import json, torch
torch.set_num_threads(1)
from portbench import run, spec
cell = spec.load_cell("probe.tiny")
probe = cell.arch
out = {"here": str(spec.HERE), "arch": probe.__name__, "runs": []}
for fault in (False, True):
    probe.USED.clear()
    probe.FAULT = fault
    r = run.run_cell(cell, 4, 0.0, False, device="cpu")
    out["runs"].append({"correct": r["correct"], "checks": r["checks"], "used": list(probe.USED)})
print(json.dumps(out))
"""


def test_an_architecture_arrives_as_added_files(tmp_path):
    """A copy of the benchmark gets a probe architecture, a configuration
    naming it, a mix, limits and a ``workloads`` entry; no copied file is
    edited. The tiny cell then runs through the probe's weights, reference
    and checked layer, reads ``correct``, and not with a fault planted in
    the probe's reference that only the checked layer shows."""
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    here = tmp_path / "portbench"
    (here / "arch" / "probe.py").write_text(PROBE)
    config = json.loads(json.dumps(tiny.CONFIG))
    config["port"]["architecture"] = "probe"
    for path, doc in ((here / "configs" / "probe_tiny.json", config),
                      (here / "traffic" / "probe_tiny.json", tiny.TRAFFIC),
                      (here / "limits" / "probe.tiny.json", tiny.LIMITS)):
        path.write_text(json.dumps(doc))
    added = json.loads(json.dumps(bench))
    added["configs"].append({"name": "probe_tiny", "source": tiny.CONFIG["source"],
                             "file": "portbench/configs/probe_tiny.json", "reduced": [],
                             "why": "a probe architecture"})
    added["workloads"].append({"name": "probe.tiny", "config": "probe_tiny",
                               "traffic": "probe_tiny", "chips": 1, "why": "the probe"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))

    env = {**os.environ, "PYTHONPATH": str(spec.ROOT)}  # the program, after the copy
    p = subprocess.run([sys.executable, "-c", RUN_PROBE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["here"] == str(here) and out["arch"] == "portbench.arch.probe"
    sound, faulted = out["runs"]
    # the program's weights, the check's weights, the check's reference
    assert sound["used"] == faulted["used"] == ["make_weights", "make_weights",
                                                "Reference checked 1"]
    assert sound["correct"]
    assert not faulted["correct"]
    assert faulted["checks"]["kv_rel_err_l0"]["value"] > tiny.LIMITS["kv_rel_err_l0"]

    for path in spec.HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (here / path.relative_to(spec.HERE)).read_bytes() == path.read_bytes(), path
    for key in ("configs", "workloads"):
        assert added[key][:len(bench[key])] == bench[key]
