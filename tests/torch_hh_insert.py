"""A one-slot heavy-hitter kv8 cache to insert into, and a tensor's bits:
shared by the fused rotate-and-insert's tests on the CPU and on the card."""

import torch

from cold_compress_tpu_torch.caches import base, get_cache_strategy

CACHE_FIELDS = ("k", "v", "pos", "mask", "cache_ct", "k_scales", "k_zeros", "v_scales",
                "v_zeros")


def bits(t):
    """A tensor's bytes as integers, so that -0.0 and NaN payloads count."""
    return t.view(torch.int32) if t.dtype == torch.float32 else (
        t.view(torch.int16) if t.dtype == torch.bfloat16 else t)


def hh_kv8_state(dev, B, KVH, C, seed):
    """A kv8 heavy-hitter cache of B lanes of KVH heads of C slots (heads
    of 128) on ``dev``, the same for a seed on every device: even lanes
    hold C - 5 tokens (five empty slots), odd lanes are full, each (lane,
    head) with its positions shuffled, so that global (< 4) and recent (the
    last 10) slots lie anywhere in the row; quarter-step histories (exact
    ties: the first slot wins)."""
    g = torch.Generator().manual_seed(seed)
    spec = base.CacheSpec(cache_strategy="heavy_hitter", max_cache_length=C,
                          max_seq_length=2 * C + 64, global_tokens=4, recent_window=10,
                          cache_bits=8)
    strat = get_cache_strategy("heavy_hitter")
    state = strat.init(spec, B, KVH, 128, device=dev)
    k, v = (torch.randn((B, KVH, C, 128), generator=g).to(torch.bfloat16) for _ in range(2))
    pos = torch.stack([torch.randperm(C, generator=g) for _ in range(B * KVH)])
    fill = torch.tensor([C - 5 if b % 2 == 0 else C for b in range(B)])
    valid = (torch.arange(C)[None, None, :] < fill[:, None, None]).expand(B, KVH, C)
    base.prefill_update(strat, state, pos.reshape(B, KVH, C).to(dev, torch.int32), k.to(dev),
                        v.to(dev), valid.to(dev))
    state.extra["attn_num"].copy_((torch.randint(1, 40, (B, KVH, C), generator=g) / 4).to(dev))
    state.extra["attn_denom"].copy_(torch.randint(0, 6, (B, KVH, C), generator=g).to(dev))
    return state


def assert_same_cache(a, b):
    """Every tensor of two caches, ``num`` and ``denom`` too, bit for bit."""
    for f in CACHE_FIELDS:
        assert torch.equal(bits(getattr(a, f)), bits(getattr(b, f))), f
    for n in ("attn_num", "attn_denom"):
        assert torch.equal(bits(a.extra[n]), bits(b.extra[n])), n
