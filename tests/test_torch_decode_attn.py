"""The port's kv8 decode attention (kernel K3) against the JAX package.

On CPU tensors the wrapper takes its plain version, which carries the
kernel's arithmetic: K/V dequantized per slot and rounded to bf16, f32
scores and softmax, probabilities rounded to bf16 before P.V, pooled
probabilities averaged over the G query heads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches.base import CacheSpec as JaxSpec
from cold_compress_tpu.caches.base import init_state as jax_init_state
from cold_compress_tpu.caches.base import materialize_kv as jax_materialize
from cold_compress_tpu.caches.base import quantize_rows as jax_quantize_rows
from cold_compress_tpu.ops.attention import gqa_attention as jax_gqa
from cold_compress_tpu.ops.pallas_decode_attn import quantized_decode_attention

from cold_compress_tpu_torch.ops import decode_attn
from cold_compress_tpu_torch.ops.attention import gqa_attention

B, KVH, G, C, D = 2, 2, 4, 256, 128
H = KVH * G


def _inputs(seed=0):
    """Same numpy draws for both sides: a kv8 cache with partly empty slots
    (a different fill per lane and head) and a bf16 query."""
    rng = np.random.RandomState(seed)
    kv = rng.randn(2, B, KVH, C, D).astype(np.float32)
    qk, ks, kz = jax_quantize_rows(jnp.asarray(kv[0]), 8)
    qv, vs, vz = jax_quantize_rows(jnp.asarray(kv[1]), 8)
    filled = rng.randint(C // 4, C, size=(B, KVH))
    mask = np.arange(C)[None, None, :] < filled[:, :, None]
    mask &= rng.rand(B, KVH, C) > 0.1  # evicted holes
    q = (rng.randn(B, H, 1, D) / 8).astype(np.float32)
    return dict(
        q=q, kq=np.asarray(qk), vq=np.asarray(qv), ks=np.asarray(ks),
        kz=np.asarray(kz), vs=np.asarray(vs), vz=np.asarray(vz), mask=mask,
    )


def _port(a):
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    return decode_attn.decode_attention(
        t["q"].to(torch.bfloat16), t["kq"], t["vq"], t["ks"], t["kz"], t["vs"],
        t["vz"], t["mask"], bits=8, need_attn=True,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_tpu_kernel(seed):
    """Against the TPU one-shot kernel in interpret mode (bits=8,
    need_attn=True, i8dot=False). Same roundings on both sides, so only f32
    summation order differs: out within 1 bf16 ulp, pooled to f32 noise."""
    a = _inputs(seed)
    ref_out, ref_attn = quantized_decode_attention(
        jnp.asarray(a["q"], jnp.bfloat16), jnp.asarray(a["kq"]), jnp.asarray(a["vq"]),
        jnp.asarray(a["ks"]), jnp.asarray(a["kz"]), jnp.asarray(a["vs"]),
        jnp.asarray(a["vz"]), jnp.asarray(a["mask"]),
        bits=8, need_attn=True, chunked=False, i8dot=False, interpret=True,
    )
    out, pooled = _port(a)
    assert out.shape == (B, H, 1, D) and out.dtype == torch.bfloat16
    assert pooled.shape == (B, KVH, 1, C) and pooled.dtype == torch.float32
    ref_out = np.asarray(ref_out, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=8e-3, atol=1e-3)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)
    assert np.all(pooled.numpy()[~a["mask"][:, :, None, :]] == 0.0)


# The JAX package's default for kv8 caches is the i8dot branch
# (pallas_decode_attn.py:938-942): q quantized per row to int8, integer
# scores, p * s_v quantized per row to int8 for P.V. The port keeps the
# dequantizing branch by design. Measured against i8dot=True on these draws
# (seeds 0 and 1): out off by up to 8.43e-3 and 7.35e-3 of each head's
# largest |out|, pooled probabilities by up to 1.23e-3 and 1.34e-3 of
# themselves. The bounds are under twice the larger of each.
I8DOT_OUT_SHARE = 1.6e-2
I8DOT_POOLED_RTOL = 2.6e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_within_bound_of_tpu_i8dot_kernel(seed):
    """Against the TPU one-shot kernel in interpret mode with i8dot=True:
    out within ``I8DOT_OUT_SHARE`` of each head's largest |out|, pooled
    probabilities within ``I8DOT_POOLED_RTOL`` of themselves, and zero
    exactly where the reference's are (empty slots)."""
    a = _inputs(seed)
    ref_out, ref_attn = quantized_decode_attention(
        jnp.asarray(a["q"], jnp.bfloat16), jnp.asarray(a["kq"]), jnp.asarray(a["vq"]),
        jnp.asarray(a["ks"]), jnp.asarray(a["kz"]), jnp.asarray(a["vs"]),
        jnp.asarray(a["vz"]), jnp.asarray(a["mask"]),
        bits=8, need_attn=True, chunked=False, i8dot=True, interpret=True,
    )
    out, pooled = _port(a)
    ref = np.asarray(ref_out, np.float32)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= I8DOT_OUT_SHARE * scale), float((err / scale).max())
    ref_p, p = np.asarray(ref_attn), pooled.numpy()
    assert np.all((p == 0) == (ref_p == 0))
    live = ref_p > 0
    rel = np.abs(p[live] - ref_p[live]) / ref_p[live]
    assert float(rel.max()) <= I8DOT_POOLED_RTOL, float(rel.max())


def test_plain_matches_xla_path():
    """Against the JAX XLA path (materialize_kv + gqa_attention), which
    keeps the probabilities in f32 for P.V: out differs by the bf16
    rounding of the probabilities (2**-9 relative), pooled not at all
    beyond f32 noise."""
    a = _inputs(2)
    spec = JaxSpec(cache_strategy="heavy_hitter", max_cache_length=C,
                   max_seq_length=C, cache_bits=8)
    st = jax_init_state(spec, B, KVH, D).replace(
        k=jnp.asarray(a["kq"]), v=jnp.asarray(a["vq"]),
        k_scales=jnp.asarray(a["ks"]), k_zeros=jnp.asarray(a["kz"]),
        v_scales=jnp.asarray(a["vs"]), v_zeros=jnp.asarray(a["vz"]),
        mask=jnp.asarray(a["mask"]),
    )
    k, v = jax_materialize(st)  # bf16, as the kernel rounds them
    ref_out, ref_attn = jax_gqa(
        jnp.asarray(a["q"], jnp.bfloat16), k, v,
        mask=st.mask[:, :, None, None, :], return_attn=True,
    )
    out, pooled = _port(a)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_out, np.float32),
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)

    # The port's own XLA-path counterpart agrees with JAX's to f32 noise.
    out2, attn2 = gqa_attention(
        torch.from_numpy(a["q"]).to(torch.bfloat16),
        torch.from_numpy(np.asarray(k, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16),
        mask=torch.from_numpy(a["mask"])[:, :, None, None, :], return_attn=True,
    )
    np.testing.assert_allclose(out2.float().numpy(), np.asarray(ref_out, np.float32),
                               rtol=8e-3, atol=1e-3)
    np.testing.assert_allclose(attn2.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)


def test_cpu_tensors_do_not_count_as_launches():
    before = dict(decode_attn.LAUNCHES)
    _port(_inputs(3))
    assert decode_attn.LAUNCHES == before
    assert decode_attn.decode_attn_supported((1, 32, 1, 128), 8)
    assert not decode_attn.decode_attn_supported((1, 32, 1, 64), 8)
    assert not decode_attn.decode_attn_supported((1, 32, 2, 128), 8)


# ---------------------------------------------------------------------------
# Every cache precision (K3's other branches and K5)
# ---------------------------------------------------------------------------


def _cache_inputs(bits, C, seed):
    """A cache at ``bits`` (16 = bf16 values) with partly empty slots and a
    bf16 query, the same numpy draws for both sides."""
    rng = np.random.RandomState(seed)
    kv = rng.randn(2, B, KVH, C, D).astype(np.float32)
    filled = rng.randint(C // 4, C, size=(B, KVH))
    mask = np.arange(C)[None, None, :] < filled[:, :, None]
    mask &= rng.rand(B, KVH, C) > 0.1
    q = (rng.randn(B, H, 1, D) / 8).astype(np.float32)
    if bits == 16:
        k = np.asarray(jnp.asarray(kv[0], jnp.bfloat16))
        v = np.asarray(jnp.asarray(kv[1], jnp.bfloat16))
        side = [None] * 4
    else:
        k, ks, kz = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(kv[0]), bits))
        v, vs, vz = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(kv[1]), bits))
        side = [ks, kz, vs, vz]
    return q, k, v, side, mask


def _jax_decode(q, k, v, side, mask, bits, need_attn, chunked):
    j = [None if a is None else jnp.asarray(a) for a in side]
    return quantized_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v), *j, jnp.asarray(mask),
        bits=bits, need_attn=need_attn, chunked=chunked, i8dot=False, interpret=True,
    )


def _port_decode(q, k, v, side, mask, bits, need_attn):
    def t(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return decode_attn.decode_attention(
        t(q).to(torch.bfloat16), t(k), t(v), *[t(a) for a in side], t(mask),
        bits=bits, need_attn=need_attn,
    )


@pytest.mark.parametrize("need_attn", [True, False])
@pytest.mark.parametrize("bits", [16, 4, 2])
def test_every_precision_matches_tpu_one_shot_kernel(bits, need_attn):
    """Against the TPU one-shot kernel in interpret mode: the same
    dequantization (segment unpack for 4/2 bits), the same roundings, so
    only f32 summation order differs: out within 1 bf16 unit (rtol 8e-3,
    atol 1e-3), pooled to f32 noise (rtol 1e-5)."""
    a = _cache_inputs(bits, C, 10 + bits)
    ref_out, ref_attn = _jax_decode(*a, bits, need_attn, chunked=False)
    out, pooled = _port_decode(*a, bits, need_attn)
    assert out.shape == (B, H, 1, D) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_out, np.float32),
                               rtol=8e-3, atol=1e-3)
    if need_attn:
        np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)
    else:
        assert pooled is None and ref_attn is None


# The TPU's chunked kernel (K5) rounds the unnormalised e = exp(s - m_run)
# to bf16 before P.V and divides by l at the end; the port follows the
# one-shot kernel at every C and rounds the normalised p. Each probability
# then moves by up to 2**-9 of itself on each side, so |out - ref| stays
# below 2 bf16 units of the output's scale: 2 * 2**-8 * max|ref| per head.
CHUNKED_OUT_UNITS = 2


@pytest.mark.parametrize("need_attn", [True, False])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_long_cache_matches_tpu_chunked_kernel(bits, need_attn):
    """Against the TPU chunked kernel in interpret mode (C = 1024, two
    512-slot chunks): out within the bound above, pooled probabilities to
    f32 noise (the TPU corrects each chunk's e-block with the final (m, l),
    which is what the port computes)."""
    Cl = 1024
    a = _cache_inputs(bits, Cl, 20 + bits)
    ref_out, ref_attn = _jax_decode(*a, bits, need_attn, chunked=True)
    out, pooled = _port_decode(*a, bits, need_attn)
    ref = np.asarray(ref_out, np.float32)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= CHUNKED_OUT_UNITS * 2.0**-8 * scale), float((err / scale).max())
    if need_attn:
        np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("Cb", [300, 1024])
def test_bf16_cache_matches_xla_path(Cb):
    """A bf16 cache above the TPU's one-shot budget, and any C that is not
    a multiple of 128, goes to the XLA einsum in the JAX package
    (materialize_kv + gqa_attention, f32 probabilities in P.V); the port
    keeps its kernel, which rounds the probabilities to bf16. out then
    stays within the same two units as against the chunked kernel, and the
    pooled probabilities agree to f32 noise."""
    q, k, v, side, mask = _cache_inputs(16, Cb, 31)
    ref_out, ref_attn = jax_gqa(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask)[:, :, None, None, :], return_attn=True,
    )
    out, pooled = _port_decode(q, k, v, side, mask, 16, True)
    ref = np.asarray(ref_out, np.float32)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= CHUNKED_OUT_UNITS * 2.0**-8 * scale), float((err / scale).max())
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_attn), rtol=1e-5, atol=1e-7)
