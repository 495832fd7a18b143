"""Attention-loss analysis cache (``debug_<strategy>``).

Port of ``cold_compress_tpu/caches/analysis.py``. Attention runs over a full
bf16 cache of the whole sequence while a shadow cache of the wrapped
strategy, configured by the user's spec, follows along; each decode step
records the attention mass the shadow's evictions lost:
``loss = 1 - sum of the attention probabilities of the shadow's kept
positions``, averaged over batch and heads. The shadow state lives in the
outer state's ``extra`` and is updated in place with it.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import CacheSpec, init_state, prefill_update
from .prompt_compression import compress_prompt, get_prompt_compressor
from .strategies import FullCache

_ANALYSIS_CACHE = {}


def make_analysis_strategy(inner_name: str):
    """The (memoised) analysis strategy class wrapping ``inner_name``."""
    if inner_name in _ANALYSIS_CACHE:
        return _ANALYSIS_CACHE[inner_name]
    from . import get_cache_strategy

    inner = get_cache_strategy(inner_name)

    class AnalysisCache(FullCache):
        name = f"debug_{inner_name}"
        # Attention probabilities are always needed to measure the loss.
        needs_attn = True
        inner_strategy = inner

        @classmethod
        def init(cls, spec, batch_size, n_kv_heads, head_dim, dtype=torch.bfloat16,
                 device=None):
            # The outer cache is a full bf16 cache over the whole sequence
            # (cache_bits stays None); the user's spec configures the shadow.
            outer_spec = CacheSpec(
                cache_strategy=cls.name,
                max_cache_length=spec.max_seq_length,
                max_seq_length=spec.max_seq_length,
                global_tokens=0,
                prompt_compression_strategy=spec.prompt_compression_strategy,
            )
            inner_spec = dataclasses.replace(spec, cache_strategy=inner_name)
            state = init_state(outer_spec, batch_size, n_kv_heads, head_dim, dtype,
                               device=device)
            state.extra["shadow"] = inner.init(inner_spec, batch_size, n_kv_heads, head_dim,
                                               dtype, device=device)
            state.extra["attention_losses"] = torch.full(
                (spec.max_seq_length,), -1.0, dtype=torch.float32, device=device)
            state.extra["attention_loss_ctr"] = torch.zeros((), dtype=torch.int32,
                                                            device=device)
            return state

        @classmethod
        def reset_extra(cls, spec, extra):
            """Restore the -1 "unwritten" sentinel of the loss buffer (a 0
            would read as a real loss)."""
            extra["attention_losses"].fill_(-1.0)
            return extra

        @classmethod
        def decode_update(cls, state, input_pos, k, v, token=None):
            inner.decode_update(state.extra["shadow"], input_pos, k, v, token=token)
            # The outer full-cache append; attention runs over the full cache.
            return super().decode_update(state, input_pos, k, v, token=token)

        @classmethod
        def update_state(cls, spec, state, input_pos, attn, is_prefill=False,
                         prompt_len=None):
            # Prefill records no loss: full and compressed prefill attention
            # are the same. The shadow is filled in post_prefill.
            if attn is None or is_prefill:
                return state
            shadow = state.extra["shadow"]
            # The full-cache attention at the shadow's kept positions; empty
            # shadow slots (-1) read the last slot and count 0.
            empty = shadow.pos == -1
            idx = torch.where(empty, attn.shape[-1] - 1, shadow.pos).long()
            attn_c = torch.where(empty, 0.0, attn.gather(-1, idx))
            inner.update_state(shadow.spec, shadow, input_pos, attn_c, is_prefill=False)
            loss = (1.0 - attn_c.sum(dim=-1)).mean()
            ex = state.extra
            ex["attention_losses"].scatter_(0, ex["attention_loss_ctr"].long().reshape(1),
                                            loss.reshape(1))
            ex["attention_loss_ctr"] += 1
            return state

        @classmethod
        def post_prefill(cls, spec, state, k, v, summary, input_pos, valid, prompt_len,
                         tokens=None):
            """Fill the shadow after the outer full fill, compressing the
            prompt with the shadow's compressor where it exceeds the shadow's
            budget."""
            shadow = state.extra["shadow"]
            sspec = shadow.spec
            P = k.shape[2]
            if sspec.max_cache_length < P:
                compressor = get_prompt_compressor(sspec.prompt_compression_strategy)
                keep_pos, k_c, v_c, keep_valid, kept_attn = compress_prompt(
                    compressor, sspec, input_pos, k, v, valid, prompt_len, summary=summary)
                prefill_update(inner, shadow, keep_pos, k_c, v_c, keep_valid)
                if kept_attn is None and summary is not None:
                    kept_attn = summary["cum_mean"].gather(-1, keep_pos.long())
            else:
                prefill_update(inner, shadow, input_pos[None, None, :], k, v, valid[:, None, :])
                kept_attn = summary["cum_mean"] if summary is not None else None
            inner.update_state(sspec, shadow, input_pos, kept_attn, is_prefill=True,
                               prompt_len=prompt_len)
            return state

    AnalysisCache.__name__ = f"AnalysisCache_{inner_name}"
    _ANALYSIS_CACHE[inner_name] = AnalysisCache
    return AnalysisCache
