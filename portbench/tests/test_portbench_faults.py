"""A run whose timed path is broken underneath comes out not correct: the
harness is driven as on the card, with the program's step faulted on the
CPU. The cells run on one card, so there is no exchange between chips to
leave out."""

import pytest
import torch

from cold_compress_tpu_torch.models import transformer
from cold_compress_tpu_torch.runtime import generate as gen
from portbench import run
from portbench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def correct(batch: int, seed: int = 21) -> bool:
    return run.run_cell(tiny.cell(batch=batch, bias=batch > 1), seed, 0.3, False,
                        device="cpu")["correct"]


@pytest.mark.parametrize("batch", [1, 4])
def test_sound_runs_are_correct(batch):
    assert correct(batch)


@pytest.mark.parametrize("batch", [1, 4])
def test_a_step_that_leaves_the_cache_unchanged(batch, monkeypatch):
    monkeypatch.setattr(transformer, "decode_update",
                        lambda strategy, state, input_pos, k, v, token=None: state)
    assert not correct(batch)


def test_half_of_the_batch_left_out(monkeypatch):
    """Lanes 2 and 3 are given lanes 0 and 1's answers, as if only half
    the batch had been computed."""
    real = gen.generate_batch

    def half(model, caches, prompts, *a, **kw):
        seqs, info, caches = real(model, caches, prompts, *a, **kw)
        lens, half_b = info["prompt_lengths"], len(prompts) // 2
        for b in range(half_b, len(prompts)):
            seqs[b] = seqs[b][:lens[b]] + seqs[b - half_b][lens[b - half_b]:]
            info["emitted_probs"][b] = info["emitted_probs"][b - half_b]
        return seqs, info, caches

    monkeypatch.setattr(gen, "generate_batch", half)
    assert not correct(4)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """Every served token one id off, with the probabilities the program
    gave the tokens it chose."""
    real = gen.generate

    def altered(model, caches, prompt, *a, **kw):
        seq, info, caches = real(model, caches, prompt, *a, **kw)
        n = info["prompt_length"]
        seq[n:] = [(t + 1) % model.cfg.vocab_size for t in seq[n:]]
        return seq, info, caches

    monkeypatch.setattr(gen, "generate", altered)
    assert not correct(1)
