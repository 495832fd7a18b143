"""Random int4 leaves, made on the device from a seeded generator.

``int4_leaves`` makes every int4 weight of a model in two draws from one
``torch.Generator`` on the device: one for every packed weight byte, one
for every scale and zero. An architecture module (``arch/``) draws the
rest of its tree (embedding, norms, biases) from the same generator after
it, so the same seed gives the same tensors and the reference makes them
again after the program's state is freed. Each leaf is ``{"w": int8
[in/2, out], "scales", "zeros": bf16 [in/gs, out], "group_size"}``: byte r
holds input row r in its low nibble (unsigned q) and row r + in/2 in its
high nibble (signed q - 8); ``w = (q - 8) * s + z``. Scales are
``s = SCALE * U(0.5, 1.5)`` and zeros ``z = s * U(0, 1)`` (bf16), so that
every part of the dequantization carries weight and each group's mean,
``z - s / 2`` (q is uniform over 0..15), is zero on average: weights with a
common offset would give every hidden state one shared direction, and the
model one token.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

#: The scale of one int4 step: weights span about +-0.02, as
#: ``random_quantized_params`` of the port draws them.
SCALE = 0.02 / 8


def int4_leaves(gen: torch.Generator, shapes: Sequence[Tuple[int, int]], gs: int,
                device) -> List[dict]:
    """One int4 leaf per (in, out) of ``shapes``, in order."""
    n_bytes = sum(i * o // 2 for i, o in shapes)
    n_groups = sum(i // gs * o for i, o in shapes)
    packed = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8, device=device,
                           generator=gen).view(torch.int8)
    u = torch.rand((2, n_groups), device=device, generator=gen)
    scales = (SCALE * (0.5 + u[0])).to(torch.bfloat16)
    zeros = (SCALE * (0.5 + u[0]) * u[1]).to(torch.bfloat16)
    del u
    leaves = []
    ob = og = 0
    for i, o in shapes:
        nb, ng = i * o // 2, i // gs * o
        leaves.append({"w": packed[ob:ob + nb].view(i // 2, o),
                       "scales": scales[og:og + ng].view(i // gs, o),
                       "zeros": zeros[og:og + ng].view(i // gs, o), "group_size": gs})
        ob, og = ob + nb, og + ng
    return leaves

