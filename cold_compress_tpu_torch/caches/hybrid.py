"""FastGen-style hybrid cache: per-head compression policies chosen by
profiling the prompt's attention.

Port of ``cold_compress_tpu/caches/hybrid.py``. Each KV head is assigned
the first entry of a static policy menu whose kept tokens recover at least
``min_recovery_frac`` of the head's prompt attention; the per-head policy is
an integer index into the menu, and every policy-dependent quantity
(budgets, protected slots, eviction scores) is a gather of that index, so
one decode step serves every head with no Python loop over heads and no
host sync.

Menu entries (``hybrid_strategies``) combine components:
  special        keep special tokens (chat/control ids)
  punc           keep punctuation tokens
  window         keep a recent window (fraction of the cache length)
  heavy_hitter   keep the top-attention-mass tokens (fraction)
  full           keep everything

The prefill profile (column sums of the normalised prompt attention, and
the same restricted to each recent window) comes from kernel K6
(``ops/prefill_attn.py::flash_profile``) together with the attention
output, or from the chunked plain math for shapes K6 does not take.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.attention import NEG_INF, _plen
from .base import (
    CacheSpec,
    CacheState,
    gather_rows,
    gather_scalar,
    input_pos_b11,
    scatter_rows,
    scatter_scalar,
    store_kv_prefix,
    store_kv_rows,
)
from .heavy_hitter import HeavyHitterCache


@dataclass(frozen=True)
class HybridStrategy:
    strategy: str
    recent_window: float = 0.0
    heavy_hitter_frac: float = 0.0


def normalize_hybrid_strategies(entries) -> Tuple[HybridStrategy, ...]:
    """YAML list-of-dicts -> hashable menu tuple."""
    out = []
    for e in entries:
        if isinstance(e, HybridStrategy):
            out.append(e)
        else:
            out.append(HybridStrategy(
                strategy=e["strategy"],
                recent_window=float(e.get("recent_window", 0.0)),
                heavy_hitter_frac=float(e.get("heavy_hitter_frac", 0.0)),
            ))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _menu_tables_cached(spec: CacheSpec, device: str):
    menu = spec.hybrid_strategies
    if not menu:
        raise ValueError("hybrid cache requires a hybrid_strategies menu")
    C = spec.max_cache_length

    def tab(fn, dtype):
        return torch.tensor([fn(s) for s in menu], dtype=dtype, device=device)

    return {
        "has_special": tab(lambda s: "special" in s.strategy, torch.bool),
        "has_punc": tab(lambda s: "punc" in s.strategy, torch.bool),
        "has_window": tab(lambda s: "window" in s.strategy, torch.bool),
        "has_hh": tab(lambda s: "heavy_hitter" in s.strategy, torch.bool),
        "is_full": tab(lambda s: s.strategy == "full", torch.bool),
        "window_len": tab(
            lambda s: round(s.recent_window * C) if "window" in s.strategy else 0, torch.int32
        ),
        "hh_budget": tab(
            lambda s: round(s.heavy_hitter_frac * C) if "heavy_hitter" in s.strategy else 0,
            torch.int32,
        ),
        "punc_ids": torch.tensor(spec.token_ids_punc, dtype=torch.long, device=device),
    }


def _menu_tables(spec: CacheSpec, device=None):
    """Static per-policy component tables, gathered by the per-head index.
    Built once per (spec, device): building them inside the decode loop
    would copy host memory to the card at every layer of every step."""
    dev = torch.device(device or "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _menu_tables_cached(spec, str(dev))


def _special_token_mask(spec: CacheSpec, tokens: torch.Tensor) -> torch.Tensor:
    """Mark tokens that are (part of) a special-token sequence: a single id,
    or every token of an exact multi-token subsequence."""
    B, P = tokens.shape
    mask = torch.zeros((B, P), dtype=torch.bool, device=tokens.device)
    for seq in spec.token_ids_special:
        L = len(seq)
        if L == 1:
            mask |= tokens == seq[0]
        elif P >= L:
            hit = torch.ones((B, P - L + 1), dtype=torch.bool, device=tokens.device)
            for j, tid in enumerate(seq):
                hit &= tokens[:, j : P - L + 1 + j] == tid
            for j in range(L):
                mask[:, j : P - L + 1 + j] |= hit
    return mask


def _punc_token_mask(spec: CacheSpec, tokens: torch.Tensor) -> torch.Tensor:
    if not spec.token_ids_punc:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    return torch.isin(tokens, _menu_tables(spec, tokens.device)["punc_ids"])


class HybridCache(HeavyHitterCache):
    name = "hybrid"

    @classmethod
    def menu_needs_attn(cls, spec) -> bool:
        """Decode records an attention history iff some menu entry keeps
        heavy hitters."""
        return any("heavy_hitter" in s.strategy for s in spec.hybrid_strategies)

    @staticmethod
    def init_extra(spec, B, H, D, device=None):
        C = spec.max_cache_length
        _menu_tables(spec, device)  # built here, before any decode step
        extra = HeavyHitterCache.init_extra(spec, B, H, D, device)
        kw = dict(device=device)
        extra.update({
            "strategy_idx": torch.zeros((B, H), dtype=torch.int32, **kw),
            "special_mask": torch.zeros((B, H, C), dtype=torch.bool, **kw),
            "punc_mask": torch.zeros((B, H, C), dtype=torch.bool, **kw),
            "num_special": torch.zeros((B,), dtype=torch.int32, **kw),
            "num_punc": torch.zeros((B,), dtype=torch.int32, **kw),
        })
        return extra

    # ------------------------------------------------------------------
    # Prefill: profile the heads, pick per-head policies, fill the cache
    # ------------------------------------------------------------------

    @classmethod
    def profile_prefill_with_attn(cls, spec, state, q, k, v, tokens, input_pos, valid,
                                  prompt_len):
        """Attention and profile in one pass: returns y [B, H, P, D] and
        fills ``state`` in place. Shapes K6 takes (head_dim 128, P a
        multiple of 64) go to ``flash_profile`` (the kernel on the card, its
        plain version on the CPU); others take the chunked attention and
        ``_profile_partial``, as the JAX package routes them."""
        from ..ops.attention import prefill_attention
        from ..ops.prefill_attn import flash_prefill_supported, flash_profile

        _, uniq_w = _profile_windows(spec, k.shape[2])
        if flash_prefill_supported(q.shape):
            y, cum, wcols = flash_profile(q, k, v, prompt_len, window_lens=uniq_w)
        else:
            y, _ = prefill_attention(q, k, v, valid, prompt_len)
            cum, wcols = _profile_partial(spec, q, k, prompt_len)
        cls.fill_after_profile(spec, state, cum, wcols, k, v, tokens, input_pos, valid,
                               prompt_len)
        return y

    @classmethod
    def fill_after_profile(cls, spec, state, cum, wcols, k, v, tokens, input_pos, valid,
                           prompt_len) -> CacheState:
        """Menu scoring, per-head policy pick, keep mask and the reordered
        fill: kept valid tokens first (original order), then the other
        valid ones, pads last (a stable sort); slots past each head's kept
        count are empty. The heavy-hitter history is seeded with the kept
        tokens' query-averaged attention."""
        B, KVH, P, D = k.shape
        C = spec.max_cache_length
        if C < P:
            raise ValueError(f"hybrid needs max_cache_length ({C}) >= the padded prompt ({P})")
        special = _special_token_mask(spec, tokens) & valid
        punc = _punc_token_mask(spec, tokens) & valid
        cum_attn, scores = _profile_finalize(spec, cum, wcols, valid, prompt_len, special, punc)
        # The first menu entry recovering at least min_recovery_frac; entry
        # 0 when none does (argmax returns the first maximum).
        qualifies = (scores >= spec.min_recovery_frac).to(torch.int32)
        strategy_idx = qualifies.argmax(dim=0).to(torch.int32)
        keep = _keep_mask_for_filling(spec, strategy_idx, cum_attn, special, punc, input_pos,
                                      valid, prompt_len)
        sort_key = keep.to(torch.int32) * 2 + valid[:, None, :].to(torch.int32)
        order = torch.sort(-sort_key, dim=-1, stable=True).indices  # [B, KVH, P]

        def take(x):  # [B, KVH or 1, P] -> reordered [B, KVH, P]
            return x.expand(B, KVH, P).gather(-1, order)

        gidx = order[..., None].expand(B, KVH, P, D)
        k_o, v_o = k.gather(2, gidx), v.gather(2, gidx)
        pos_o = take(input_pos.to(torch.int32)[None, None, :])
        keep_o = keep.gather(-1, order)
        cache_ct = keep_o.sum(dim=-1).to(torch.int32)
        live = torch.arange(P, device=k.device) < cache_ct[..., None]

        store_kv_prefix(state, k_o, v_o)
        state.pos[:, :, :P] = torch.where(live, pos_o, -1)
        state.mask[:, :, :P] = live
        state.cache_ct.copy_(cache_ct)
        ex = state.extra
        ex["strategy_idx"].copy_(strategy_idx)
        ex["special_mask"][:, :, :P] = take(special[:, None, :]) & live
        ex["punc_mask"][:, :, :P] = take(punc[:, None, :]) & live
        ex["num_special"].copy_(special.sum(dim=-1))
        ex["num_punc"].copy_(punc.sum(dim=-1))
        if cls.menu_needs_attn(spec):
            seeded = torch.where(live, cum_attn.gather(-1, order), 0.0)
            HeavyHitterCache.update_state(spec, state, input_pos, seeded, is_prefill=True,
                                          prompt_len=prompt_len)
        return state

    # ------------------------------------------------------------------
    # Decode: one vectorised insert/evict step for every head's policy
    # ------------------------------------------------------------------

    @classmethod
    def decode_update(cls, state: CacheState, input_pos, k, v, token=None) -> CacheState:
        """Insert one token, in place. Per head: append (a ``full`` policy,
        a punctuation keeper seeing a punctuation token, or a head under its
        budget), else evict the lowest-scored unprotected slot (windowed or
        heavy-hitter policies), else drop the token into the dummy slot
        C - 1, which then stays byte-identical. Evicted slots' histories
        are zeroed; punctuation slots are tracked."""
        spec = state.spec
        B, KVH = state.cache_ct.shape
        C = spec.max_cache_length
        dev = state.pos.device
        ipos = input_pos_b11(input_pos, B, dev)  # [B, 1, 1]
        tables = _menu_tables(spec, dev)
        sidx = state.extra["strategy_idx"].long()

        def gat(name):
            return tables[name][sidx]  # [B, KVH]

        has_special, has_punc = gat("has_special"), gat("has_punc")
        has_window, has_hh = gat("has_window"), gat("has_hh")
        is_full, window_len, hh_budget = gat("is_full"), gat("window_len"), gat("hh_budget")
        if token is not None and spec.token_ids_punc:
            # A compare against every id: torch.isin of one token against
            # a few dozen ids sorts them on the card, two launches a layer.
            is_punc_tok = (token.reshape(B, 1) == tables["punc_ids"]).any(dim=-1)
        else:
            is_punc_tok = torch.zeros((B,), dtype=torch.bool, device=dev)

        ex = state.extra
        ct = state.cache_ct
        budget = (
            spec.global_tokens
            + torch.where(has_special, ex["num_special"][:, None], 0)
            + torch.where(has_punc, ex["num_punc"][:, None], 0)
            + torch.where(has_window, window_len, 0)
            + torch.where(has_hh, hh_budget, 0)
        )
        append_idx = ct.clamp(max=C - 1)
        append = is_full | (has_punc & is_punc_tok[:, None]) | (ct < budget)
        evictor = has_window | has_hh
        evict = ~append & evictor
        no_insert = ~append & ~evictor

        # Eviction scores: the average attention history for heavy-hitter
        # policies, the position (oldest first) for the others.
        W = spec.history_window_size
        if W == 1:
            hh_score = ex["attn_num"] / ex["attn_denom"].clamp_min(1).float()
        else:
            hh_score = ex["attn_num"].sum(dim=-1) / ex["attn_denom"].clamp(1, W).float()
        score = torch.where(has_hh[..., None], hh_score, state.pos.float())
        slot = torch.arange(C, device=dev)
        save = (
            (slot < spec.global_tokens)
            | (has_special[..., None] & ex["special_mask"])
            | (has_punc[..., None] & ex["punc_mask"])
            | (has_window[..., None] & (state.pos > ipos - window_len[..., None]))
            | (slot >= ct[..., None])  # only filled slots are candidates
        )
        score = torch.where(save, math.inf, score)
        evict_idx = score.argmin(dim=-1)  # the first minimum, as jnp.argmin
        # Every filled slot protected: drop the token rather than overwrite
        # a global one (argmin over all-inf scores is slot 0).
        protected_all = torch.isinf(score).all(dim=-1)
        drop = no_insert | (evict & protected_all)
        evict = evict & ~protected_all
        fill_idx = torch.where(drop, C - 1, torch.where(evict, evict_idx, append_idx))

        store_kv_rows(state, fill_idx, k[:, :, 0], v[:, :, 0], skip=drop)
        new_pos = torch.where(drop, gather_scalar(state.pos, fill_idx), ipos[:, :, 0])
        new_mask = torch.where(drop, gather_scalar(state.mask, fill_idx), True)
        scatter_scalar(state.pos, fill_idx, new_pos)
        scatter_scalar(state.mask, fill_idx, new_mask)
        # Clamped at C: an always-append head reuses slot C - 1 once full.
        state.cache_ct.copy_((ct + append.to(torch.int32)).clamp(max=C))

        if cls.menu_needs_attn(spec):
            if W == 1:
                cur = gather_scalar(ex["attn_num"], fill_idx)
                scatter_scalar(ex["attn_num"], fill_idx, torch.where(evict, 0.0, cur))
            else:
                cur = gather_rows(ex["attn_num"], fill_idx)
                scatter_rows(ex["attn_num"], fill_idx, torch.where(evict[..., None], 0.0, cur))
            curd = gather_scalar(ex["attn_denom"], fill_idx)
            scatter_scalar(ex["attn_denom"], fill_idx, torch.where(evict, 0, curd))
        if spec.token_ids_punc:
            cur = gather_scalar(ex["punc_mask"], fill_idx)
            scatter_scalar(ex["punc_mask"], fill_idx, cur | is_punc_tok[:, None])
            ex["num_punc"] += is_punc_tok.to(torch.int32)
        return state

    @classmethod
    def update_state(cls, spec, state, input_pos, attn, is_prefill, prompt_len=None):
        if is_prefill or not cls.menu_needs_attn(spec):  # prefill seeds in the fill
            return state
        return HeavyHitterCache.update_state(spec, state, input_pos, attn, is_prefill,
                                             prompt_len)

    @classmethod
    def strategy_histogram(cls, spec, state) -> torch.Tensor:
        """Share of heads on each menu entry."""
        sidx = state.extra["strategy_idx"].reshape(-1).long()
        counts = torch.bincount(sidx, minlength=len(spec.hybrid_strategies))
        return counts.float() / sidx.numel()


# --------------------------------------------------------------------------
# Profiling
# --------------------------------------------------------------------------


def _ceil_f32(x: float) -> int:
    """ceil of a Python float taken in f32, as ``jnp.ceil`` takes it."""
    return math.ceil(float(np.float32(x)))


def _strategy_base_cols(spec, s: HybridStrategy, cum_attn, special, punc, input_pos, valid,
                        prompt_len, total_len) -> torch.Tensor:
    """Query-independent kept columns of one menu entry, bool [B, KVH, P]:
    globals, special and punctuation tokens and heavy hitters (the window
    depends on the query and is handled by the callers)."""
    B, KVH, P = cum_attn.shape
    dev = cum_attn.device
    base = ((input_pos < spec.global_tokens)[None, None, :] & valid[:, None, :]).expand(B, KVH, P)
    if "special" in s.strategy:
        base = base | special[:, None, :]
    if "punc" in s.strategy:
        base = base | punc[:, None, :]
    if "heavy_hitter" in s.strategy:
        # Heavy hitters come from the columns neither the base mask nor the
        # last query's window already keeps.
        w = max(1, int(s.recent_window * total_len)) if "window" in s.strategy else 0
        if w > 0:
            last_q = (_plen(prompt_len, B, dev) - 1)[:, None, None]
            in_last_window = (input_pos[None, None, :] > last_q - w) & (
                input_pos[None, None, :] <= last_q)
        else:
            in_last_window = torch.zeros((1, 1, P), dtype=torch.bool, device=dev)
        avail = valid[:, None, :] & ~base & ~in_last_window
        k_max = max(1, min(P, math.ceil(s.heavy_hitter_frac * total_len)))
        num_hh = avail.sum(dim=-1).clamp(max=_ceil_f32(s.heavy_hitter_frac * total_len))
        masked = torch.where(avail, cum_attn, NEG_INF)
        # Stable descending sort: ties keep the lower index first, as
        # jax.lax.top_k does (torch.topk promises no order).
        topv, topi = torch.sort(masked, dim=-1, descending=True, stable=True)
        topv, topi = topv[..., :k_max], topi[..., :k_max]
        sel = (torch.arange(k_max, device=dev) < num_hh[..., None]) & (topv > NEG_INF)
        hh = torch.zeros((B, KVH, P), dtype=torch.bool, device=dev).scatter(-1, topi, sel)
        base = base | hh
    if s.strategy == "full":
        base = valid[:, None, :].expand(B, KVH, P)
    return base


def _profile_windows(spec, P):
    """Each menu entry's window length at total_len = P (0 without a
    window), and the distinct non-zero ones in ascending order."""
    window_lens = [
        max(1, int(s.recent_window * P)) if "window" in s.strategy else 0
        for s in spec.hybrid_strategies
    ]
    return window_lens, sorted({w for w in window_lens if w > 0})


def _profile_partial(spec, q, k, prompt_len, q_offset: int = 0, chunk_size: int = 512):
    """Raw profile accumulators (cum [B, KVH, P], wcols [W, B, KVH, P]) of
    a query block against the full key sequence, for the menu's distinct
    window lengths: the plain version of K6's profile
    (``ops/prefill_attn.py::profile_partial``)."""
    from ..ops.prefill_attn import profile_partial

    _, uniq_w = _profile_windows(spec, k.shape[2])
    return profile_partial(q, k, prompt_len, tuple(uniq_w), q_offset=q_offset,
                           chunk_size=chunk_size)


def _profile_finalize(spec, cum, wcols, valid, prompt_len, special, punc):
    """The query-averaged column attention ``cum_attn`` [B, KVH, P] and each
    menu entry's recovered share of the prompt attention, scores [S, B,
    KVH]. With colsum = cum and, per window w, wcolsum_w = wcols[w]:
    recovered = dot(base, colsum) + sum(wcolsum_w) - dot(base, wcolsum_w)
    (static columns, window mass, their overlap counted once)."""
    B, KVH, P = cum.shape
    dev = cum.device
    input_pos = torch.arange(P, dtype=torch.int32, device=dev)
    window_lens, uniq_w = _profile_windows(spec, P)
    plen = _plen(prompt_len, B, dev)
    denom = (plen[:, None] - input_pos[None, :]).clamp_min(1).float()  # [B, P]
    cum_attn = cum / denom[:, None, :]
    sums = []
    for si, s in enumerate(spec.hybrid_strategies):
        base = _strategy_base_cols(spec, s, cum_attn, special, punc, input_pos, valid,
                                   prompt_len, P).float()
        tot = (base * cum).sum(dim=-1)
        w = window_lens[si]
        if w > 0:
            wc = wcols[uniq_w.index(w)]
            tot = tot + wc.sum(dim=-1) - (base * wc).sum(dim=-1)
        sums.append(tot)
    n_q = plen.clamp_min(1).float()
    return cum_attn, torch.stack(sums) / n_q[None, :, None]


def _keep_mask_for_filling(spec, strategy_idx, cum_attn, special, punc, input_pos, valid,
                           prompt_len) -> torch.Tensor:
    """Each head's kept prompt tokens under its policy, at total_len = the
    cache length and with the last query's window."""
    B, KVH, P = cum_attn.shape
    C = spec.max_cache_length
    dev = cum_attn.device
    masks = []
    for s in spec.hybrid_strategies:
        base = _strategy_base_cols(spec, s, cum_attn, special, punc, input_pos, valid,
                                   prompt_len, C)
        if "window" in s.strategy:
            w = max(1, int(s.recent_window * C))
            last_q = (_plen(prompt_len, B, dev) - 1)[:, None, None]
            in_window = (input_pos[None, None, :] > last_q - w) & (input_pos[None, None, :] <= last_q)
            base = base | (in_window & valid[:, None, :])
        masks.append(base.expand(B, KVH, P))
    stacked = torch.stack(masks)  # [S, B, KVH, P]
    return stacked.gather(0, strategy_idx.long()[None, :, :, None].expand(1, B, KVH, P))[0]
