"""Heavy-hitter (ScissorHands / H2O-style) cache strategy.

Port of ``cold_compress_tpu/caches/heavy_hitter.py``. Evicts the slot with
the lowest windowed average attention. With a one-slot history the eviction
is the fused step of ``ops/evict.py`` (kernel K7 on the card, opt-in in the
JAX package only for want of validation on the TPU); thresholding changes
only the observations, not the eviction. A ring of W > 1 observations takes
the eager code below. The history lives in
``extra``: a numerator of attention mass per slot and a count of
observations, both updated in place after every attention call and zeroed
at the evicted slot.
"""

from __future__ import annotations

import torch

from ..ops.evict import hh_evict
from .base import CacheStrategy


class HeavyHitterCache(CacheStrategy):
    name = "heavy_hitter"
    needs_attn = True

    @staticmethod
    def init_extra(spec, B, H, D, device=None):
        C, W = spec.max_cache_length, spec.history_window_size
        return {
            # W == 1 accumulates the full history in one slot; W > 1 keeps a
            # ring of the last W observations.
            "attn_num": torch.zeros(
                (B, H, C) if W == 1 else (B, H, C, W), dtype=torch.float32, device=device
            ),
            "attn_denom": torch.zeros((B, H, C), dtype=torch.int32, device=device),
            "attn_counter": torch.zeros((), dtype=torch.int32, device=device),
        }

    @classmethod
    def eviction_idx(cls, spec, state, input_pos) -> torch.Tensor:
        W = spec.history_window_size
        num_buf = state.extra["attn_num"]
        denom_buf = state.extra["attn_denom"]
        if W == 1:
            return hh_evict(num_buf, denom_buf, state.pos, input_pos,
                            global_tokens=spec.global_tokens,
                            recent_window=spec.recent_window)
        avg = num_buf.sum(dim=-1) / denom_buf.clamp(1, W).float()
        protected = (state.pos < spec.global_tokens) | (
            state.pos >= input_pos - spec.recent_window
        )
        avg = torch.where(protected, 1.0, avg)
        avg = torch.where(state.pos == -1, 0.0, avg)
        idx = avg.argmin(dim=-1)  # first minimum, like jnp
        # Zero the attention history of the newly claimed slot.
        num_buf.scatter_(2, idx[..., None, None].expand(idx.shape + (1, W)), 0.0)
        denom_buf.scatter_(2, idx[..., None], 0)
        return idx.to(torch.int32)

    @classmethod
    def update_state(cls, spec, state, input_pos, attn, is_prefill, prompt_len=None):
        """Add the latest [B, KVH, C]-aligned attention observation."""
        if attn is None:
            return state
        W = spec.history_window_size
        attn = attn.float()
        C = state.pos.shape[-1]
        if attn.shape[-1] < C:
            attn = torch.nn.functional.pad(attn, (0, C - attn.shape[-1]))
        if spec.attn_thresholding:
            uniform = 1.0 / state.cache_ct.float().clamp_min(1.0)
            attn = (attn >= uniform[..., None]).float()
        ex = state.extra
        if W == 1:
            ex["attn_num"] += attn
        else:
            slot = ex["attn_counter"].long() % W
            ex["attn_num"].index_copy_(3, slot.reshape(1), attn[..., None])
        ex["attn_denom"] += 1
        ex["attn_counter"] += 1
        return state
