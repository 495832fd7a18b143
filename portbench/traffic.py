"""One generator for every traffic mix: closed-loop calls in rounds.

A mix file lists one round of calls (``calls``), each call the prompt
lengths of its lanes, taken from the benchmark the mix names (``source``).
Every call of a mix has the same number of lanes (``batch``). The run sends
round after round; each round sends every call of the list once, in an
order drawn from the seed. So any run sees the same lengths, and a window
of whole rounds the same work, whatever the seed; the seed draws the order
and the token ids, uniform in [5, vocab - 5).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def bucket_length(n: int, minimum: int = 16) -> int:
    """The power of two a prompt of n tokens is padded to (the program's
    prefill bucket)."""
    b = minimum
    while b < n:
        b *= 2
    return b


class Traffic:
    """The calls of one run of a mix, drawn from ``seed``."""

    def __init__(self, doc: dict, vocab: int, seed: int):
        self.round = [[int(n) for n in call] for call in doc["calls"]]
        self.batch = len(self.round[0])
        if any(len(call) != self.batch for call in self.round):
            raise ValueError(f"every call of a mix has the same lanes: {self.round}")
        self.lengths = sorted({n for call in self.round for n in call})
        self.max_new_tokens = int(doc["max_new_tokens"])
        self.vocab = vocab
        self.rng = np.random.default_rng(int(seed))

    def prompt(self, n: int) -> List[int]:
        return self.rng.integers(5, self.vocab - 5, size=n).tolist()

    def rounds(self) -> Iterator[List[List[List[int]]]]:
        """Endless rounds: each a list of calls, each call a list of
        ``batch`` prompts."""
        while True:
            yield [[self.prompt(n) for n in self.round[i]]
                   for i in self.rng.permutation(len(self.round))]

    def buckets(self) -> List[int]:
        """Every prefill bucket a call uses: that of its longest lane."""
        return sorted({bucket_length(max(call)) for call in self.round})

    def warm_prompts(self) -> List[List[List[int]]]:
        """One call per bucket: the call of that bucket with the longest
        lane."""
        out = []
        for b in self.buckets():
            call = max((c for c in self.round if bucket_length(max(c)) == b), key=max)
            out.append([self.prompt(n) for n in call])
        return out
