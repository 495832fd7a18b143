"""The ``i8dot`` branch of the port's decode attention (K3/K5) against the
JAX package's TPU kernels in interpret mode, its routing, and the graph key.

The JAX package's default for an int8 cache is the kernel's integer branch
(pallas_decode_attn.py:930-942): q quantized per row to int8, scores as
int32 dots plus rank-1 f32 fix-ups, ``p * s_v`` quantized per row to int8
for an int32 P.V. The port takes the same branch where the TPU program
would (``ops/decode_attn.py::i8dot_route``); on CPU tensors the wrapper
runs its plain version, ``decode_attention_i8dot_plain``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches.base import quantize_rows as jax_quantize_rows
from cold_compress_tpu.ops.pallas_decode_attn import quantized_decode_attention

from cold_compress_tpu_torch.ops import decode_attn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, KVH, G, C, D = 2, 2, 4, 256, 128
H = KVH * G

# Against the TPU one-shot kernel with i8dot=True on these draws (seeds 0
# and 1, bits 8/4/2, with and without pooled probabilities): out off by up
# to 1.50e-3 of each head's largest |out| (kv4, seed 0: single bf16
# roundings of the output, whose f32 value differs in the order of the f32
# sums; kv8 bit-equal), pooled probabilities by up to 2.66e-7 of
# themselves. The bounds are under twice those, and 6.4 and 5,200 times
# tighter than the dequantizing branch's bounds against the same kernel
# (1.6e-2 and 2.6e-3, tests/test_torch_decode_attn.py).
OUT_SHARE = 2.5e-3
POOLED_RTOL = 5e-7
# The TPU's chunked kernel (C = 1024, two 512-slot chunks) quantizes each
# chunk's unnormalised e with its own scale; the port quantizes the
# normalised p with one scale over all C. Measured: out off by up to
# 7.69e-3 (kv8) and 7.63e-3 (kv4) of each head's largest |out|, pooled as
# one-shot (2.36e-7). The bound is under twice that.
CHUNKED_OUT_SHARE = 1.2e-2


def _inputs(bits, Cn, seed):
    """A cache at ``bits`` with partly empty slots (a different fill per lane
    and head, evicted holes) and a bf16 query, the same numpy draws for both
    sides."""
    rng = np.random.RandomState(seed)
    kv = rng.randn(2, B, KVH, Cn, D).astype(np.float32)
    filled = rng.randint(Cn // 4, Cn, size=(B, KVH))
    mask = np.arange(Cn)[None, None, :] < filled[:, :, None]
    mask &= rng.rand(B, KVH, Cn) > 0.1
    q = (rng.randn(B, H, 1, D) / 8).astype(np.float32)
    k, ks, kz = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(kv[0]), bits))
    v, vs, vz = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(kv[1]), bits))
    return q, k, v, [ks, kz, vs, vz], mask


def _tpu(a, bits, need_attn, chunked):
    q, k, v, side, mask = a
    out, pooled = quantized_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
        *[jnp.asarray(x) for x in side], jnp.asarray(mask),
        bits=bits, need_attn=need_attn, chunked=chunked, i8dot=True, interpret=True,
    )
    return np.asarray(out, np.float32), None if pooled is None else np.asarray(pooled)


def _port(a, bits, need_attn, i8dot=True):
    q, k, v, side, mask = (x if isinstance(x, list) else torch.from_numpy(np.array(x))
                           for x in a)
    side = [torch.from_numpy(np.array(x)) for x in side]
    return decode_attn.decode_attention(q.to(torch.bfloat16), k, v, *side, mask, bits=bits,
                                        need_attn=need_attn, i8dot=i8dot)


def _out_share(out, ref):
    """Largest |out - ref| over each head's largest |ref|."""
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    return float((np.abs(out.float().numpy() - ref) / scale).max())


def _pooled_rel(pooled, ref):
    p = pooled.numpy()
    assert np.all((p == 0) == (ref == 0))  # empty slots exactly where the reference's are
    live = ref > 0
    return float((np.abs(p[live] - ref[live]) / ref[live]).max())


@pytest.mark.parametrize("need_attn", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_tpu_one_shot_kernel(seed, bits, need_attn):
    """Against the TPU one-shot kernel (``chunked=False``) with i8dot=True:
    out within ``OUT_SHARE`` of each head's largest |out|, pooled
    probabilities within ``POOLED_RTOL`` of themselves; no launch counted."""
    a = _inputs(bits, C, seed)
    ref_out, ref_pooled = _tpu(a, bits, need_attn, chunked=False)
    before = dict(decode_attn.LAUNCHES)
    out, pooled = _port(a, bits, need_attn)
    assert decode_attn.LAUNCHES == before
    assert out.shape == (B, H, 1, D) and out.dtype == torch.bfloat16
    assert _out_share(out, ref_out) <= OUT_SHARE
    if need_attn:
        assert pooled.shape == (B, KVH, 1, C) and pooled.dtype == torch.float32
        assert _pooled_rel(pooled, ref_pooled) <= POOLED_RTOL
    else:
        assert pooled is None and ref_pooled is None


def test_dequantizing_branch_falls_outside_the_i8dot_bounds():
    """On the same draw, the ``i8dot=False`` plain version is outside both
    bounds (8.43e-3 on out and 1.23e-3 on pooled, against 2.5e-3 and 5e-7),
    so the test above tells the two branches apart."""
    a = _inputs(8, C, 0)
    ref_out, ref_pooled = _tpu(a, 8, True, chunked=False)
    out, pooled = _port(a, 8, True, i8dot=False)
    assert _out_share(out, ref_out) > 3 * OUT_SHARE
    assert _pooled_rel(pooled, ref_pooled) > 1000 * POOLED_RTOL


@pytest.mark.parametrize("need_attn", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_long_cache_within_bound_of_tpu_chunked_kernel(bits, need_attn):
    """Against the TPU chunked kernel (``chunked=True``, C = 1024): out
    within ``CHUNKED_OUT_SHARE`` of each head's largest |out| (per-chunk
    against one probability scale), pooled probabilities as one-shot (the
    TPU corrects each chunk's e with the final (m, l))."""
    a = _inputs(bits, 1024, 20 + bits)
    ref_out, ref_pooled = _tpu(a, bits, need_attn, chunked=True)
    out, pooled = _port(a, bits, need_attn)
    assert _out_share(out, ref_out) <= CHUNKED_OUT_SHARE
    if need_attn:
        assert _pooled_rel(pooled, ref_pooled) <= POOLED_RTOL


@pytest.mark.parametrize("bits,Cn,kvh,want", [
    (8, 2048, 8, True),      # the main path's budget
    (8, 128, 2, True),       # TestKernel at a quarter of 512
    (8, 8192, 8, True),      # hybrid's full cache, one-shot on the TPU
    (8, 32768, 8, True),     # above the one-shot budget: the TPU's chunked kernel
    (8, 4093, 8, False),     # the pyramid's first layer: not a multiple of 128
    (8, 300, 2, False),
    (4, 2048, 8, False),     # sub-byte caches: off unless asked (CCT_ATTN_I8DOT=1)
    (2, 2048, 8, False),
    (16, 2048, 8, False),
])
def test_auto_routing_copies_the_tpu_default(bits, Cn, kvh, want):
    assert decode_attn.i8dot_route("auto", bits, Cn, kvh) is want
    assert decode_attn.i8dot_route(False, bits, Cn, kvh) is False
    if bits != 16:
        assert decode_attn.i8dot_route(True, bits, Cn, kvh) is True


def test_tpu_kernel_gate_copy():
    """``tpu_runs_kernel`` at the JAX gate's corners: head_dim, the bf16
    one-shot budget (40 MiB) and the chunk path's bound (10 MiB per chunk)."""
    assert not decode_attn.tpu_runs_kernel(8, 2048, 8, head_dim=64)
    assert decode_attn.tpu_runs_kernel(16, 8192, 8)            # 32 MiB of bf16 K+V
    assert not decode_attn.tpu_runs_kernel(16, 32768, 8)       # 128 MiB: the XLA einsum
    assert decode_attn.tpu_runs_kernel(8, 32768, 8)            # chunked, 1 MiB a chunk
    assert not decode_attn.tpu_runs_kernel(8, 131072 + 128, 8)  # 256 MiB, not chunkable


def test_i8dot_at_bf16_raises():
    with pytest.raises(ValueError, match="quantized cache"):
        decode_attn.i8dot_route(True, 16, 2048, 8)
    with pytest.raises(ValueError, match="mode"):
        decode_attn.i8dot_route("on", 8, 2048, 8)
    q = torch.zeros((1, 4, 1, D), dtype=torch.bfloat16)
    kv = torch.zeros((1, 1, 128, D), dtype=torch.bfloat16)
    mask = torch.ones((1, 1, 128), dtype=torch.bool)
    with pytest.raises(ValueError, match="i8dot"):
        decode_attn.decode_attention(q, kv, kv, None, None, None, None, mask, bits=16,
                                     need_attn=True, i8dot=True)


def test_model_decode_routes_by_mode():
    """TestKernel over a kv8 heavy-hitter cache of 128 slots: ``auto`` takes
    the i8dot branch there (the same logits as True, bit for bit), False the
    dequantizing one; a bad mode raises."""
    from cold_compress_tpu_torch.bench import cache_kwargs
    from cold_compress_tpu_torch.models import transformer as TT
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model
    from cold_compress_tpu_torch.runtime.engine import params_from_flat

    cfg = ModelConfig.from_name("TestKernel")
    model = build_model(cfg, params_from_flat(random_quantized_params(cfg, seed=0), "cpu"),
                        "cpu", max_positions=512)
    assert model.attn_i8dot == "auto"
    specs = build_cache_specs(cfg, cache_kwargs("heavy_hitter", 0.25, 4, 8), 512)
    prompt = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    logits = {}
    for mode in ("auto", True, False):
        TT.set_attn_i8dot(model, mode)
        caches = TT.init_caches(cfg, specs, 1, torch.bfloat16, device="cpu")
        with torch.inference_mode():
            TT.prefill(model, caches, torch.tensor([prompt + [0] * 212]), 300)
            logits[mode] = TT.decode_step(model, caches, torch.tensor([7]), 300)
    assert caches[0].k.shape[2] == 128
    assert torch.equal(logits["auto"], logits[True])
    assert not torch.equal(logits["auto"], logits[False])
    with pytest.raises(ValueError, match="attn_i8dot"):
        TT.set_attn_i8dot(model, "on")


def test_graph_key_differs_between_modes():
    """A decode graph captured under one mode is never replayed under
    another: the mode is part of the key (a Python attribute that no tensor
    holds)."""
    from cold_compress_tpu_torch.models import transformer as TT
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.runtime.cuda_graph import graph_key
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model

    cfg = ModelConfig.from_name("TestTiny")
    model = build_model(cfg, TT.init_params(cfg, device="cpu"), "cpu", max_positions=128)
    kw = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25],
          "prompt_compression_strategy": ["heavy_hitter"], "cache_bits": 8}
    caches = TT.init_caches(cfg, build_cache_specs(cfg, kw, 128), 1, device="cpu")
    keys = []
    for mode in ("auto", True, False):
        TT.set_attn_i8dot(model, mode)
        keys.append(graph_key(model, caches, 1, 1.0, 0))
    assert len(set(keys)) == 3
    TT.set_attn_i8dot(model, "auto")
    assert graph_key(model, caches, 1, 1.0, 0) == keys[0]
