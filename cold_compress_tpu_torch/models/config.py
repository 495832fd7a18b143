"""Model configuration registry.

A copy of ``cold_compress_tpu/models/config.py`` (the port imports nothing
from the JAX package): ``ModelConfig``, ``RopeScaling`` and
``MODEL_CONFIGS``. Configs are frozen (hashable) dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class RopeScaling:
    """RoPE frequency scaling: Llama-3.1's (``rope_type`` ``"llama3"``,
    reference: model.py:124-130) or YaRN's (``"yarn"``, arXiv:2309.00071,
    as ``transformers``' ``_compute_yarn_parameters``: ``beta_fast``,
    ``beta_slow`` and ``attention_factor``, which multiplies cos and sin;
    None takes ``0.1 ln(factor) + 1``)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None


#: ``layer_types`` values (the published ``config.json``'s names).
FULL_ATTENTION = "full_attention"
SLIDING_ATTENTION = "sliding_attention"


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description of a decoder-only transformer.

    Mirrors the fields of the reference ``ModelArgs`` (model.py:27-50) as
    an immutable dataclass. ``n_kv_head`` is the reference's
    ``n_local_heads`` (GQA key/value head count). ``head_dim`` is
    ``dim // n_head`` unless ``explicit_head_dim`` gives it (Mellum2: 128
    where 2304 / 32 is 72).

    Fields the Llama family leaves at their defaults:

    * ``layer_types`` (one per layer, ``FULL_ATTENTION`` or
      ``SLIDING_ATTENTION``; None: every layer full) and ``sliding_window``:
      a sliding layer's query at position i sees keys j with
      ``i - sliding_window < j <= i``; its cache is a ring of exactly
      ``sliding_window`` slots whatever policy the full layers take
      (``runtime/engine.py::build_cache_specs``);
    * ``rope_scaling`` scales the full layers' rope; the sliding layers take
      plain rope at ``rope_base`` (Mellum2's ``rope_parameters``);
    * ``n_experts`` > 0 makes the MLP of every layer that
      ``mlp_layer_types`` marks ``"sparse"`` (None: every layer) a mixture
      of experts: a router (softmax over ``n_experts`` in f32), the top
      ``n_experts_per_tok``, their weights divided by their sum where
      ``norm_topk_prob``, and SwiGLU experts of width
      ``moe_intermediate_size``.
    """

    name: str = "unknown"
    block_size: int = 2048
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: Optional[int] = None
    n_kv_head: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    attention_bias: bool = False
    max_length: int = 4096
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = False
    explicit_head_dim: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None
    sliding_window: Optional[int] = None
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    mlp_layer_types: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.n_kv_head == -1:
            object.__setattr__(self, "n_kv_head", self.n_head)
        if self.intermediate_size is None:
            hidden_dim = 4 * self.dim
            n_hidden = int(2 * hidden_dim / 3)
            object.__setattr__(
                self, "intermediate_size", find_multiple(n_hidden, 256)
            )
        object.__setattr__(self, "head_dim", self.explicit_head_dim or self.dim // self.n_head)
        for name in ("layer_types", "mlp_layer_types"):
            kinds = getattr(self, name)
            if kinds is not None:
                object.__setattr__(self, name, tuple(kinds))
                if len(kinds) != self.n_layer:
                    raise ValueError(f"{name}: {len(kinds)} entries for {self.n_layer} layers")
        if self.layer_types is not None:
            if set(self.layer_types) - {FULL_ATTENTION, SLIDING_ATTENTION}:
                raise ValueError(f"unknown layer types {set(self.layer_types)}")
            if SLIDING_ATTENTION in self.layer_types and not self.sliding_window:
                raise ValueError("sliding layers need a sliding_window")
        if self.n_experts and not 0 < self.n_experts_per_tok <= self.n_experts:
            raise ValueError(f"top-{self.n_experts_per_tok} of {self.n_experts} experts")

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

    def is_sliding(self, layer: int) -> bool:
        """Whether ``layer`` attends over a sliding window."""
        return self.layer_types is not None and self.layer_types[layer] == SLIDING_ATTENTION

    def is_moe(self, layer: int) -> bool:
        """Whether ``layer``'s MLP is a mixture of experts."""
        return self.n_experts > 0 and (self.mlp_layer_types is None
                                       or self.mlp_layer_types[layer] == "sparse")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_name(cls, name: str) -> "ModelConfig":
        """Resolve a config by exact then fuzzy name (reference: model.py:52-71)."""
        if name in MODEL_CONFIGS:
            return cls(name=name, **MODEL_CONFIGS[name])
        matches = [
            key
            for key in MODEL_CONFIGS
            if key in str(name).upper() or key in str(name)
        ]
        if len(matches) > 1:
            matches.sort(key=len, reverse=True)
            if len(matches[0]) == len(matches[1]):
                raise ValueError(f"Ambiguous model name {name}: {matches[:2]}")
        if not matches:
            raise ValueError(f"Unknown model name: {name}")
        return cls(name=matches[0], **MODEL_CONFIGS[matches[0]])


# Architecture registry. Mirrors reference model.py:74-171 (same model families:
# Llama-2 class ("7B"/"13B"/...), CodeLlama, Mistral, Llama-3/3.1, Qwen2,
# stories test configs) so checkpoint-name resolution behaves identically.
MODEL_CONFIGS = {
    "CodeLlama-7b-Python-hf": dict(
        block_size=16384, vocab_size=32000, n_layer=32, dim=4096, rope_base=1000000.0
    ),
    "7B": dict(n_layer=32, n_head=32, dim=4096),
    "13B": dict(n_layer=40, n_head=40, dim=5120),
    "30B": dict(n_layer=60, n_head=52, dim=6656),
    "34B": dict(
        n_layer=48,
        n_head=64,
        dim=8192,
        vocab_size=32000,
        n_kv_head=8,
        intermediate_size=22016,
        rope_base=1000000.0,
    ),
    "70B": dict(
        n_layer=80, n_head=64, dim=8192, n_kv_head=8, intermediate_size=28672
    ),
    "Mistral-7B": dict(
        n_layer=32,
        n_head=32,
        n_kv_head=8,
        dim=4096,
        intermediate_size=14336,
        vocab_size=32000,
    ),
    "stories15M": dict(n_layer=6, n_head=6, dim=288),
    "stories110M": dict(n_layer=12, n_head=12, dim=768),
    "Meta-Llama-3-8B-Instruct": dict(
        block_size=8192,
        n_layer=32,
        n_head=32,
        n_kv_head=8,
        dim=4096,
        intermediate_size=14336,
        vocab_size=128256,
        rope_base=500000.0,
        max_length=8192,
    ),
    "Meta-Llama-3.1-8B-Instruct": dict(
        block_size=131072,
        n_layer=32,
        n_head=32,
        n_kv_head=8,
        dim=4096,
        intermediate_size=14336,
        vocab_size=128256,
        rope_base=500000.0,
        max_length=131072,
        rope_scaling=RopeScaling(
            factor=8.0,
            low_freq_factor=1.0,
            high_freq_factor=4.0,
            original_max_position_embeddings=8192,
            rope_type="llama3",
        ),
    ),
    "Qwen2-1.5B-Instruct": dict(
        block_size=32768,
        n_layer=28,
        n_head=12,
        n_kv_head=2,
        dim=1536,
        intermediate_size=8960,
        vocab_size=151936,
        rope_base=1000000.0,
        attention_bias=True,
        norm_eps=1e-6,
        max_length=32768,
    ),
    "Qwen2-0.5B-Instruct": dict(
        block_size=32768,
        n_layer=24,
        n_head=14,
        n_kv_head=2,
        dim=896,
        intermediate_size=4864,
        vocab_size=151936,
        rope_base=1000000.0,
        attention_bias=True,
        norm_eps=1e-6,
        max_length=32768,
        tie_word_embeddings=True,
    ),
    "Qwen2-7B-Instruct": dict(
        block_size=32768,
        n_layer=28,
        n_head=28,
        n_kv_head=4,
        dim=3584,
        intermediate_size=18944,
        vocab_size=152064,
        rope_base=1000000.0,
        attention_bias=True,
        norm_eps=1e-6,
        max_length=32768,
    ),
    # JetBrains/Mellum2-12B-A2.5B-Instruct (config.json on the hub): 28
    # layers in periods of three sliding-window layers (default rope) and
    # one full layer (YaRN over 8192 original positions), GQA 32/4 heads of
    # 128, every MLP 64 SwiGLU experts of width 896, top 8 renormalised.
    "Mellum2-12B-A2.5B": dict(
        block_size=131072,
        n_layer=28,
        n_head=32,
        n_kv_head=4,
        dim=2304,
        explicit_head_dim=128,
        intermediate_size=7168,
        vocab_size=98304,
        rope_base=500000.0,
        norm_eps=1e-6,
        max_length=131072,
        rope_scaling=RopeScaling(factor=16.0, original_max_position_embeddings=8192,
                                 rope_type="yarn", beta_fast=32.0, beta_slow=1.0,
                                 attention_factor=1.2772588722239782),
        layer_types=tuple(FULL_ATTENTION if i % 4 == 3 else SLIDING_ATTENTION
                          for i in range(28)),
        sliding_window=1024,
        n_experts=64,
        n_experts_per_tok=8,
        moe_intermediate_size=896,
        norm_topk_prob=True,
    ),
    # One period of Mellum2's pattern at tiny widths (tests, CLI runs on the
    # CPU): heads of 128 and a 128-token window, so that the kv8 caches'
    # fused insert and the integer-dot decode attention take their paths.
    "TestMellum2": dict(
        block_size=512,
        n_layer=4,
        n_head=2,
        n_kv_head=1,
        dim=256,
        explicit_head_dim=128,
        intermediate_size=128,
        vocab_size=512,
        rope_base=500000.0,
        norm_eps=1e-6,
        max_length=512,
        rope_scaling=RopeScaling(factor=4.0, original_max_position_embeddings=32,
                                 rope_type="yarn", beta_fast=32.0, beta_slow=1.0,
                                 attention_factor=1.1386294361119891),
        layer_types=(SLIDING_ATTENTION,) * 3 + (FULL_ATTENTION,),
        sliding_window=128,
        n_experts=8,
        n_experts_per_tok=4,
        moe_intermediate_size=128,
    ),
    # Trained tiny fixture: a ~5M-param byte-level LM trained offline on
    # local text (scripts/train_tiny.py) so the converter→quantize→eval
    # pipeline can produce REAL task metrics without network access. The
    # "byte" in the name routes get_tokenizer to the ByteTokenizer.
    "TinyByteLM": dict(
        block_size=2048,
        n_layer=6,
        n_head=4,
        n_kv_head=2,
        dim=256,
        intermediate_size=768,
        vocab_size=512,
        rope_base=10000.0,
        norm_eps=1e-5,
        max_length=2048,
    ),
    # head_dim=128 variant: the Pallas decode-attention kernels gate on
    # D % 128 == 0 (ops/pallas_decode_attn.py::decode_attn_supported), so
    # quality A/Bs of the quantized-KV kernel paths (i8dot score dots)
    # need a TRAINED fixture whose shapes actually route through them —
    # TinyByteLM's head_dim=64 silently falls back to the XLA math path.
    "TinyByteLM128": dict(
        block_size=2048,
        n_layer=6,
        n_head=2,
        n_kv_head=1,
        dim=256,
        intermediate_size=768,
        vocab_size=512,
        rope_base=10000.0,
        norm_eps=1e-5,
        max_length=2048,
    ),
    # Tiny fixtures for tests / CI (TPU build's own test strategy; the
    # reference has none, SURVEY.md §4).
    "TestTiny": dict(
        block_size=256,
        n_layer=2,
        n_head=4,
        n_kv_head=2,
        dim=64,
        intermediate_size=128,
        vocab_size=512,  # covers the byte tokenizer's special ids (256-257)
        rope_base=10000.0,
        max_length=256,
    ),
    "TestTinyLong": dict(
        block_size=32768,
        n_layer=2,
        n_head=4,
        n_kv_head=2,
        dim=64,
        intermediate_size=128,
        vocab_size=512,
        rope_base=100000.0,
        max_length=32768,
    ),
    "TestKernel": dict(
        # Smallest dims satisfying every Pallas-kernel alignment gate
        # (dim % 256, head_dim % 128, OUT % 128, prefill bucket % 512):
        # drives the hardware kernel paths end-to-end on CPU in interpret
        # mode (tests/test_gates_e2e.py, CCT_PALLAS_INTERPRET=1).
        block_size=512,
        n_layer=2,
        n_head=2,
        n_kv_head=1,
        dim=256,
        intermediate_size=512,
        vocab_size=512,
        rope_base=10000.0,
        max_length=512,
    ),
    "TestTinyMQA": dict(
        block_size=128,
        n_layer=3,
        n_head=4,
        n_kv_head=1,
        dim=64,
        intermediate_size=96,
        vocab_size=128,
        rope_base=10000.0,
        max_length=128,
    ),
}
