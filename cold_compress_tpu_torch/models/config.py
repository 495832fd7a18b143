"""Model configuration registry.

A copy of ``cold_compress_tpu/models/config.py`` (the port imports nothing
from the JAX package): ``ModelConfig``, ``RopeScaling`` and
``MODEL_CONFIGS``. Configs are frozen (hashable) dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1 style RoPE frequency scaling (reference: model.py:124-130)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description of a decoder-only transformer.

    Mirrors the fields of the reference ``ModelArgs`` (model.py:27-50) as
    an immutable dataclass. ``n_kv_head`` is the reference's
    ``n_local_heads`` (GQA key/value head count).
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

    def __post_init__(self):
        if self.n_kv_head == -1:
            object.__setattr__(self, "n_kv_head", self.n_head)
        if self.intermediate_size is None:
            hidden_dim = 4 * self.dim
            n_hidden = int(2 * hidden_dim / 3)
            object.__setattr__(
                self, "intermediate_size", find_multiple(n_hidden, 256)
            )
        object.__setattr__(self, "head_dim", self.dim // self.n_head)

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

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
