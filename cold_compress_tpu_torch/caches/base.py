"""KV-cache framework: fixed-budget caches as dataclasses of tensors.

Counterpart of ``cold_compress_tpu/caches/base.py``. The JAX version is
functional (each op returns a new ``CacheState``); here every op updates the
state's tensors IN PLACE and returns the same state object.

Protocol (the reference contract):
  * decode: insert the new token BEFORE attention. Eviction scores every
    slot, protects globals, prefers empty slots, and writes at the argmin.
  * prefill: full attention first, then (optionally compressed) K/V fill the
    cache contiguously from slot 0.

Shapes (B = batch, KVH = kv heads, C = budget, D = head dim):
  k/v:       [B, KVH, C, D]       (model dtype, or packed uint8 when quantized)
  pos:       [B, KVH, C] int32    original position of each slot, -1 = empty
  mask:      [B, KVH, C] bool     valid slots
  cache_ct:  [B, KVH]   int32     number of filled slots
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

NEG_INF = float("-inf")
POS_INF = float("inf")


@dataclass(frozen=True)
class CacheSpec:
    """Static configuration of one layer's cache (field names follow the
    reference CLI flags)."""

    cache_strategy: str = "full"
    max_cache_length: int = 1024
    max_seq_length: int = 1024
    global_tokens: int = 1
    recent_window: int = 10
    cache_bits: Optional[int] = None
    history_window_size: int = 1
    attn_thresholding: bool = False
    prompt_compression_strategy: str = "recent_global"
    # FastGen hybrid: the policy menu (``hybrid.HybridStrategy`` entries),
    # the share of prompt attention a policy must recover, and the token
    # classes it can keep (special-token sequences, punctuation ids).
    min_recovery_frac: float = 0.9
    hybrid_strategies: Tuple[Any, ...] = ()
    token_ids_special: Tuple[Tuple[int, ...], ...] = ()
    token_ids_punc: Tuple[int, ...] = ()

    @property
    def quantized(self) -> bool:
        return self.cache_bits is not None

    @property
    def packed_head_dim_divisor(self) -> int:
        return {None: 1, 8: 1, 4: 2, 2: 4}[self.cache_bits]


@dataclass
class CacheState:
    """One layer's cache. Updated in place by the cache ops (unlike the JAX
    package, whose ``CacheState`` is immutable)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor
    cache_ct: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    k_zeros: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    v_zeros: Optional[torch.Tensor] = None
    extra: Dict[str, torch.Tensor] = field(default_factory=dict)
    spec: CacheSpec = field(default_factory=CacheSpec)

    def tensors(self):
        """Every tensor the state holds, those of a nested state in
        ``extra`` (the analysis cache's shadow) included."""
        base = [self.k, self.v, self.pos, self.mask, self.cache_ct,
                self.k_scales, self.k_zeros, self.v_scales, self.v_zeros]
        out = [t for t in base if t is not None]
        for val in self.extra.values():
            out += val.tensors() if isinstance(val, CacheState) else [val]
        return out


# --------------------------------------------------------------------------
# Quantized row storage (per-(head, slot) affine)
# --------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor, n_bit: int):
    """Quantize along the last axis. x [..., D] -> (q packed uint8, scales,
    zeros). q holds unsigned values in [0, 2^n_bit - 1]; 4/2-bit values are
    packed along D. Dequant: (q - 2^(n_bit-1)) * scale + zero."""
    xf = x.float()
    mn = xf.amin(dim=-1)
    mx = xf.amax(dim=-1)
    max_int = 2 ** n_bit - 1
    rng = (mx - mn).clamp_min(1e-6)
    scales = rng / torch.full_like(rng, max_int)  # true division on CUDA too
    zeros = mn + scales * (2 ** (n_bit - 1))
    q = torch.round((xf - mn[..., None]) / scales[..., None]).clamp(0, max_int)
    q = q.to(torch.uint8)
    if n_bit == 4:
        q = _pack_last(q, 2, 4)
    elif n_bit == 2:
        q = _pack_last(q, 4, 2)
    return q, scales, zeros


def dequantize_rows(q: torch.Tensor, scales, zeros, n_bit: int, dtype):
    if n_bit == 4:
        q = _unpack_last(q, 2, 4)
    elif n_bit == 2:
        q = _unpack_last(q, 4, 2)
    x = (q.float() - 2 ** (n_bit - 1)) * scales[..., None] + zeros[..., None]
    return x.to(dtype)


def _pack_last(q: torch.Tensor, per_byte: int, n_bit: int) -> torch.Tensor:
    """Segment packing: byte j's bit range s holds the value at position
    j + s * (D / per_byte)."""
    Dh = q.shape[-1] // per_byte
    qr = q.reshape(q.shape[:-1] + (per_byte, Dh)).to(torch.int32)
    shifts = (torch.arange(per_byte, device=q.device, dtype=torch.int32) * n_bit)[:, None]
    return (qr << shifts).sum(dim=-2).to(torch.uint8)


def _unpack_last(p: torch.Tensor, per_byte: int, n_bit: int) -> torch.Tensor:
    mask = (1 << n_bit) - 1
    pe = p.to(torch.int32)[..., None, :]
    shifts = (torch.arange(per_byte, device=p.device, dtype=torch.int32) * n_bit)[:, None]
    vals = (pe >> shifts) & mask
    return vals.reshape(p.shape[:-1] + (p.shape[-1] * per_byte,)).to(torch.uint8)


# --------------------------------------------------------------------------
# Shared machinery
# --------------------------------------------------------------------------


def init_state(spec: CacheSpec, batch_size: int, n_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, extra=None, device=None) -> CacheState:
    B, H, C, D = batch_size, n_kv_heads, spec.max_cache_length, head_dim
    kw = dict(device=device)
    if spec.quantized:
        Dp = D // spec.packed_head_dim_divisor
        k = torch.zeros((B, H, C, Dp), dtype=torch.uint8, **kw)
        v = torch.zeros((B, H, C, Dp), dtype=torch.uint8, **kw)
        qparams = dict(
            k_scales=torch.full((B, H, C), 1e-6, dtype=torch.float32, **kw),
            k_zeros=torch.zeros((B, H, C), dtype=torch.float32, **kw),
            v_scales=torch.full((B, H, C), 1e-6, dtype=torch.float32, **kw),
            v_zeros=torch.zeros((B, H, C), dtype=torch.float32, **kw),
        )
    else:
        k = torch.zeros((B, H, C, D), dtype=dtype, **kw)
        v = torch.zeros((B, H, C, D), dtype=dtype, **kw)
        qparams = {}
    return CacheState(
        k=k, v=v,
        pos=torch.full((B, H, C), -1, dtype=torch.int32, **kw),
        mask=torch.zeros((B, H, C), dtype=torch.bool, **kw),
        cache_ct=torch.zeros((B, H), dtype=torch.int32, **kw),
        extra=dict(extra or {}),
        spec=spec,
        **qparams,
    )


def reset_state(state: CacheState) -> CacheState:
    """Fresh state for a new example, in place. A nested state in ``extra``
    (the analysis cache's shadow) is reset the same way, and the owning
    strategy's ``reset_extra`` restores extras whose fresh value is not 0."""
    state.k.zero_()
    state.v.zero_()
    state.pos.fill_(-1)
    state.mask.zero_()
    state.cache_ct.zero_()
    for t in (state.k_scales, state.v_scales):
        if t is not None:
            t.fill_(1e-6)
    for t in (state.k_zeros, state.v_zeros):
        if t is not None:
            t.zero_()
    for val in state.extra.values():
        if isinstance(val, CacheState):
            reset_state(val)
        else:
            val.zero_()
    from . import get_cache_strategy

    try:
        strategy = get_cache_strategy(state.spec.cache_strategy)
    except ValueError:  # a state built outside the registry
        strategy = None
    if hasattr(strategy, "reset_extra"):
        strategy.reset_extra(state.spec, state.extra)
    return state


def materialize_kv(state: CacheState, dtype=torch.bfloat16):
    """The cache contents as dense [B, KVH, C, D] tensors."""
    spec = state.spec
    if not spec.quantized:
        return state.k, state.v
    k = dequantize_rows(state.k, state.k_scales, state.k_zeros, spec.cache_bits, dtype)
    v = dequantize_rows(state.v, state.v_scales, state.v_zeros, spec.cache_bits, dtype)
    return k, v


def scatter_rows(arr: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """arr [B,H,C,...] <- rows [B,H,...] at slot idx [B,H], in place."""
    index = idx.long().reshape(idx.shape + (1,) * (arr.dim() - 2))
    index = index.expand(idx.shape + (1,) + tuple(arr.shape[3:]))
    arr.scatter_(2, index, rows.unsqueeze(2).to(arr.dtype))


def scatter_scalar(arr: torch.Tensor, idx: torch.Tensor, val) -> None:
    """arr [B,H,C] <- val ([B,H] or scalar) at slot idx [B,H], in place."""
    index = idx.long()[..., None]
    if isinstance(val, torch.Tensor):
        arr.scatter_(2, index, val.to(arr.dtype).expand(idx.shape)[..., None])
    else:
        arr.scatter_(2, index, val)


def gather_scalar(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B,H,C] -> [B,H] at slot idx [B,H]."""
    return arr.gather(2, idx.long()[..., None])[..., 0]


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B,H,C,...] -> rows [B,H,...] at slot idx [B,H]."""
    index = idx.long().reshape(idx.shape + (1,) * (arr.dim() - 2))
    index = index.expand(idx.shape + (1,) + tuple(arr.shape[3:]))
    return arr.gather(2, index).squeeze(2)


def store_kv_rows(state: CacheState, idx: torch.Tensor, k_row: torch.Tensor,
                  v_row: torch.Tensor, skip: Optional[torch.Tensor] = None) -> CacheState:
    """Write one K/V row per (batch, head) at slot ``idx``, quantizing only
    the inserted row.

    ``skip`` [B, H] bool marks heads whose slot must stay byte-identical
    (the hybrid cache's dropping heads, whose dummy target C - 1 may hold a
    real row): their incumbent row, scales and zeros are gathered and
    written back."""
    spec = state.spec
    if spec.quantized:
        qk, ks, kz = quantize_rows(k_row, spec.cache_bits)
        qv, vs, vz = quantize_rows(v_row, spec.cache_bits)
        rows = {"k": qk, "v": qv}
        sides = {"k_scales": ks, "k_zeros": kz, "v_scales": vs, "v_zeros": vz}
    else:
        rows = {"k": k_row.to(state.k.dtype), "v": v_row.to(state.v.dtype)}
        sides = {}
    for name, row in rows.items():
        buf = getattr(state, name)
        if skip is not None:
            row = torch.where(skip[..., None], gather_rows(buf, idx), row)
        scatter_rows(buf, idx, row)
    for name, val in sides.items():
        buf = getattr(state, name)
        if skip is not None:
            val = torch.where(skip, gather_scalar(buf, idx), val)
        scatter_scalar(buf, idx, val)
    return state


def insert_rows(state: CacheState, idx: torch.Tensor, ipos: torch.Tensor,
                k_row: torch.Tensor, v_row: torch.Tensor) -> CacheState:
    """Write one token at slot ``idx`` [B, H], in place: its K/V rows
    [B, H, D] (quantized where the cache is), its position ``ipos``
    [B, 1, 1] and mask bit, and one more filled slot where the slot was
    empty."""
    B, H = idx.shape
    inserted = (gather_scalar(state.pos, idx) == -1).to(torch.int32)
    store_kv_rows(state, idx, k_row, v_row)
    scatter_scalar(state.pos, idx, ipos[:, :, 0].expand(B, H))
    scatter_scalar(state.mask, idx, True)
    state.cache_ct += inserted
    return state


def store_kv_prefix(state: CacheState, k: torch.Tensor, v: torch.Tensor) -> CacheState:
    """Write K/V [B,KVH,P,D] into slots [0, P) (prefill fill)."""
    spec = state.spec
    P = k.shape[2]
    if spec.quantized:
        qk, ks, kz = quantize_rows(k, spec.cache_bits)
        qv, vs, vz = quantize_rows(v, spec.cache_bits)
        state.k[:, :, :P] = qk
        state.v[:, :, :P] = qv
        state.k_scales[:, :, :P] = ks
        state.k_zeros[:, :, :P] = kz
        state.v_scales[:, :, :P] = vs
        state.v_zeros[:, :, :P] = vz
    else:
        state.k[:, :, :P] = k.to(state.k.dtype)
        state.v[:, :, :P] = v.to(state.v.dtype)
    return state


def input_pos_b11(input_pos, B: int, device) -> torch.Tensor:
    """A decode position (a 0-d or [B] tensor on the device, or an int) as
    a [B, 1, 1] int32 tensor. ``decode_step`` passes a device tensor, which
    a captured step reads at every replay; an int is written by a fill, for
    callers outside the decode loop."""
    if not isinstance(input_pos, torch.Tensor):
        return torch.full((B, 1, 1), int(input_pos), dtype=torch.int32, device=device)
    p = input_pos.to(device=device, dtype=torch.int32).reshape(-1)
    return p.expand(B)[:, None, None]


def protect_and_prefer_empty(scores: torch.Tensor, state: CacheState) -> torch.Tensor:
    """Shared eviction score shaping: the global-token slots (the lowest
    ones) can never be evicted, empty slots are evicted first."""
    C = scores.shape[-1]
    slot = torch.arange(C, device=scores.device)
    scores = torch.where(slot < state.spec.global_tokens, POS_INF, scores)
    return torch.where(state.pos == -1, NEG_INF, scores)


# --------------------------------------------------------------------------
# Strategy base class
# --------------------------------------------------------------------------


class CacheStrategy:
    """A cache strategy is a namespace of functions over ``CacheState``.

    Subclasses override ``token_importances`` (score-based eviction: the
    lowest score is evicted) or ``eviction_idx`` itself, plus optional
    fill and state hooks."""

    name: str = "abstract"
    needs_attn: bool = False

    @classmethod
    def init(cls, spec: CacheSpec, batch_size: int, n_kv_heads: int, head_dim: int,
             dtype=torch.bfloat16, device=None) -> CacheState:
        return init_state(
            spec, batch_size, n_kv_heads, head_dim, dtype,
            extra=cls.init_extra(spec, batch_size, n_kv_heads, head_dim, device),
            device=device,
        )

    @staticmethod
    def init_extra(spec, B, H, D, device=None) -> Dict[str, torch.Tensor]:
        return {}

    @staticmethod
    def token_importances(spec: CacheSpec, state: CacheState, input_pos) -> torch.Tensor:
        """Eviction scores broadcastable to [B, KVH, C] (lowest = evicted)."""
        raise NotImplementedError

    @classmethod
    def eviction_idx(cls, spec: CacheSpec, state: CacheState, input_pos) -> torch.Tensor:
        """[B, KVH] int32 slot indices the new token goes to; may update the
        state in place. ``input_pos`` is [B, 1, 1] int32."""
        scores = cls.token_importances(spec, state, input_pos)
        scores = protect_and_prefer_empty(scores.expand(state.pos.shape), state)
        return scores.argmin(dim=-1).to(torch.int32)  # first minimum, like jnp

    @classmethod
    def on_decode_fill(cls, spec, state: CacheState, idx, input_pos, k_row, v_row) -> CacheState:
        """Hook after a decode insert at slot ``idx`` [B, KVH]."""
        return state

    @classmethod
    def on_prefill_fill(cls, spec, state: CacheState, input_pos, k, v, valid) -> CacheState:
        """Hook after the prefill fill of slots [0, P)."""
        return state

    @classmethod
    def update_state(cls, spec, state, input_pos, attn, is_prefill, prompt_len=None):
        """Post-attention state update (``attn`` [B, KVH, C]-aligned)."""
        return state

    @classmethod
    def fuses_rotate_insert(cls, spec: CacheSpec, head_dim: int) -> bool:
        """Whether ``rotate_insert`` rotates q and k, evicts and inserts in
        one kernel for caches of ``spec`` and heads of ``head_dim``."""
        return False

    @classmethod
    def rotate_insert(cls, state: CacheState, input_pos, qkv, token=None) -> CacheState:
        """Decode's rotate-and-insert: ``qkv`` is the step's projection
        before rope (``models/rope.py::QKVRows``); its K row is rotated and
        inserted with its V row (``decode_update``), and q is left to the
        caller. A strategy that ``fuses_rotate_insert`` overrides this with
        one kernel, which leaves the rotated q in ``qkv.q_rotated``."""
        k, v = qkv.kv()
        return cls.decode_update(state, input_pos, k, v, token=token)

    @classmethod
    def decode_update(cls, state: CacheState, input_pos, k, v, token=None) -> CacheState:
        """Insert one token (pre-attention), evicting if needed, in place.
        ``token`` [B] (the current ids) is read only by strategies whose
        insert logic depends on it (hybrid, which overrides this).

        Unlike the JAX package, this does not dequantize the whole cache:
        callers that need dense K/V call ``materialize_kv`` themselves, and
        the kernel path never does (eager PyTorch would pay for it)."""
        spec = state.spec
        ipos = input_pos_b11(input_pos, state.cache_ct.shape[0], state.pos.device)
        idx = cls.eviction_idx(spec, state, ipos)
        k_row, v_row = k[:, :, 0], v[:, :, 0]
        insert_rows(state, idx, ipos, k_row, v_row)
        return cls.on_decode_fill(spec, state, idx, input_pos, k_row, v_row)


# --------------------------------------------------------------------------
# Top-level cache ops used by the model
# --------------------------------------------------------------------------


def decode_update(strategy, state: CacheState, input_pos, k, v, token=None) -> CacheState:
    """Insert one token (pre-attention), evicting if needed, in place.
    ``k``, ``v``: its rows [B, KVH, 1, hd]; or ``k`` the decode step's
    projection before rope (``models/rope.py::QKVRows``) and ``v`` None,
    which the strategy rotates and inserts (``CacheStrategy.rotate_insert``).
    ``token`` [B]: the current token ids (hybrid's punctuation tracking)."""
    if v is None:
        return strategy.rotate_insert(state, input_pos, k, token=token)
    return strategy.decode_update(state, input_pos, k, v, token=token)


def strategy_needs_attn(strategy, spec: CacheSpec) -> bool:
    """Whether decode must return attention probabilities for this cache;
    hybrid's depends on its menu."""
    if hasattr(strategy, "menu_needs_attn"):
        return strategy.menu_needs_attn(spec)
    return strategy.needs_attn


def prefill_update(strategy, state: CacheState, input_pos, k, v, valid) -> CacheState:
    """Contiguously fill slots [0, P) after prefill attention, in place.

    input_pos/valid: [B, KVH, P] or broadcastable (kept positions / real
    tokens)."""
    B, H, P, _ = k.shape
    dev = k.device
    input_pos = torch.as_tensor(input_pos, dtype=torch.int32, device=dev).expand(B, H, P)
    valid = torch.as_tensor(valid, device=dev).expand(B, H, P)
    store_kv_prefix(state, k, v)
    state.pos[:, :, :P] = torch.where(valid, input_pos, -1)
    state.mask[:, :, :P] = valid
    state.cache_ct += valid.sum(dim=-1).to(torch.int32)
    return strategy.on_prefill_fill(state.spec, state, input_pos, k, v, valid)


def cache_memory_gb(state: CacheState) -> float:
    return sum(t.numel() * t.element_size() for t in state.tensors()) / (1024 ** 3)


def compression_ratio(state: CacheState, seq_len) -> torch.Tensor:
    """Quantization-aware compression ratio: the mean over (batch, head) of
    ``(n - size) / n`` with n = seq_len - 1 (at least 1) and size the
    filled slots, scaled by cache_bits / 16 for a quantized cache."""
    n = max(int(seq_len) - 1, 1)
    size = state.cache_ct.float()
    if state.spec.cache_bits is not None:
        size = size * (state.spec.cache_bits / 16.0)
    return ((n - size) / n).mean()
