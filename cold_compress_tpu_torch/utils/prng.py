"""Counter-based random numbers, bit-exact with ``jax.random``'s default
threefry2x32 generator (with ``jax_threefry_partitionable=True``, JAX's
default since 0.5).

The random cache strategy and prompt compressor of the JAX package draw
their scores from ``jax.random`` (caches/strategies.py:84-87,
caches/prompt_compression.py:67-70). Reproducing those draws lets the port
keep and evict exactly the slots the reference does. Everything is torch
integer arithmetic on the tensors' device, with uint32 values held in int64
and wrapped by masking, so a draw needs no host synchronisation.

A key is an int64 tensor of shape [2] holding two uint32 words.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function (20 rounds), elementwise over
    broadcast int64 tensors of uint32 values."""
    ks = (k0, k1, _u32(k0 ^ k1 ^ _PARITY))
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _as_u32(v: IntLike, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device) & _MASK32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed).
    Written by device kernels, not copied from the host, so that building a
    key never waits for the card."""
    return torch.arange(2, dtype=torch.int64, device=device) * (int(seed) & _MASK32)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry2x32 of (0, data) under
    ``key``. ``data`` may be an int or a 0-d integer tensor (on the key's
    device, read without a host sync)."""
    d = _as_u32(data, key.device).reshape(())
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1])


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, as int64): element i is
    y0 ^ y1 of threefry2x32 applied to the 64-bit counter i, split into its
    high and low words."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, _u32(i))
    return (y0 ^ y1).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top 23
    random bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).clamp_min(0.0)
