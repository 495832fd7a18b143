"""The control comes out not correct: the reference one step below every
precision the configuration states (a 4-bit cache, int4 decode
activations, int8 prefill activations), read at the program's prompts and
served tokens, exceeds a limit that sound runs keep under; and so does the
program's own lower-precision path (a 4-bit cache and int8 prefill
activations) on the card."""

import pytest
import torch

from portbench import run, spec
from portbench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch,seed", [(1, 0), (1, 1), (1, 2), (4, 0), (4, 1), (4, 2)])
def test_control_fails_where_the_program_passes_tiny(batch, seed):
    r = run.run_cell(tiny.cell(batch=batch, bias=batch > 1), seed, 0.3, False, device="cpu",
                     control=True)
    assert r["correct"]
    assert any(r[f"control_{name}"] > c["limit"] for name, c in r["checks"].items())


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """On the card: the first cell at its own size, one seed each for the
    program, the reference's control and the program's own control."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell("mistral_7b_v02.ruler_niah")
    r = run.run_cell(cell, 8300000011, 6.0, False, device="cuda", control=True)
    assert r["correct"]
    assert any(r[f"control_{name}"] > c["limit"] for name, c in r["checks"].items())
    assert not run.run_cell(cell, 8300000013, 6.0, False, device="cuda",
                            program_control=True)["correct"]
