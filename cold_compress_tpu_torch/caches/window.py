"""The sliding-window layer's cache: a ring of exactly ``sliding_window``
slots, whatever policy the model's full layers take.

Position p lives at slot ``p mod W``. Prefill keeps the prompt's last W
rows (the ``recent_global`` compressor with no global tokens) and lays them
out so; each decode step writes its token over the slot of position
``p - W``, the key that just left the window, before attention. The cache
then holds exactly the keys a query at p may see (``p - W < j <= p``), the
layer equation of a windowed attention layer: no policy evicts here, so
none is asked of it. It needs no attention probabilities.

Over a kv8 cache at heads of 128 the decode step's rope and insert are one
launch (``ops/evict.py::hh_evict_insert`` with ``window=W``, the fused
heavy-hitter insert with the slot given in place of its eviction search);
every other cache inserts through the eager path at the same slot.
"""

from __future__ import annotations

import torch

from ..ops.evict import hh_evict_insert
from .base import CacheStrategy


class WindowCache(CacheStrategy):
    name = "window"
    needs_attn = False

    @classmethod
    def eviction_idx(cls, spec, state, input_pos) -> torch.Tensor:
        """Slot ``p mod W`` of each lane's position p ([B, 1, 1])."""
        B, H, W = state.pos.shape
        return (input_pos.reshape(-1, 1).long() % W).expand(B, H).to(torch.int32)

    @classmethod
    def on_prefill_fill(cls, spec, state, input_pos, k, v, valid):
        """Move the prompt's rows to their ring slots. A prefill that filled
        every slot holds W consecutive positions (the last W of a longer
        prompt, or 0..W-1 with padding past a shorter one), a permutation of
        the slots; one that filled fewer holds positions 0..P-1, already at
        their slots."""
        W = state.pos.shape[-1]
        if k.shape[2] != W:
            return state
        slot = input_pos.long() % W  # [B, H, W]
        for name in ("k", "v", "k_scales", "k_zeros", "v_scales", "v_zeros", "pos", "mask"):
            x = getattr(state, name)
            if x is None:
                continue
            idx = slot.reshape(slot.shape + (1,) * (x.dim() - 3)).expand_as(x)
            x.copy_(torch.empty_like(x).scatter_(2, idx, x))
        return state

    @classmethod
    def fuses_rotate_insert(cls, spec, head_dim: int) -> bool:
        return spec.cache_bits == 8 and head_dim == 128

    @classmethod
    def rotate_insert(cls, state, input_pos, qkv, token=None):
        """Where ``fuses_rotate_insert``: rope on q and k and the kv8 insert
        at slot ``p mod W`` in one call, the rotated q left in
        ``qkv.q_rotated``."""
        if not cls.fuses_rotate_insert(state.spec, qkv.head_dim):
            return super().rotate_insert(state, input_pos, qkv, token=token)
        qkv.q_rotated, _ = hh_evict_insert(qkv.y, qkv.freqs, state, input_pos,
                                           n_head=qkv.n_head, n_kv_head=qkv.n_kv_head,
                                           window=state.pos.shape[-1])
        return state
