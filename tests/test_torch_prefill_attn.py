"""The port's causal prefill attention with per-key summaries (kernel K4)
against the JAX package.

On CPU tensors the wrapper takes its plain version: the chunked math of
ops/attention.py (f32 scores and softmax over bf16 operands, normalised
probabilities rounded to bf16 before P.V)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.ops.attention import _chunked_prefill
from cold_compress_tpu.ops.pallas_prefill import flash_prefill as jax_flash_prefill

from cold_compress_tpu_torch.ops import attention, prefill_attn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, KVH, G, P, D = 1, 2, 2, 512, 128
H = KVH * G
PROMPT_LEN = 437  # < P: padded query rows carry weight 0 in the summaries


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, P, D).astype(np.float32)
    k = rng.randn(B, KVH, P, D).astype(np.float32)
    v = rng.randn(B, KVH, P, D).astype(np.float32)
    return q, k, v


def _port(q, k, v):
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    return prefill_attn.flash_prefill(*t, PROMPT_LEN, need_summary=True)


def _check_summary(summary, ref, rtol):
    for key in ("obs_mean", "cum_mean"):
        got = summary[key].numpy()
        want = np.asarray(ref[key])
        assert got.shape == (B, KVH, P)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
        assert np.all(got[..., PROMPT_LEN:] == 0.0), key  # no valid query sees them


def test_plain_matches_tpu_flash_kernel():
    """Against ``flash_prefill(interpret=True)``. The TPU kernel rounds the
    UNnormalised probabilities to bf16 before P.V and divides by l after;
    the plain version rounds the normalised ones: y agrees to bf16
    rounding (2**-8 relative, plus the bf16 output rounding). The summaries
    use f32 probabilities on both sides: f32 summation-order noise."""
    q, k, v = _inputs(0)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref_y, ref_sum = jax_flash_prefill(
        bf(q), bf(k), bf(v), jnp.int32(PROMPT_LEN), need_summary=True,
        interpret=True,
    )
    y, summary = _port(q, k, v)
    assert y.shape == (B, H, P, D) and y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref_y, np.float32),
                               rtol=2e-2, atol=2e-2)
    _check_summary(summary, ref_sum, rtol=2e-4)


def test_plain_matches_xla_chunked_path():
    """Against the JAX XLA path (``_chunked_prefill``): the same math, so y
    agrees to one bf16 rounding and the summaries to f32 noise."""
    q, k, v = _inputs(1)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    valid = jnp.arange(P)[None, :] < PROMPT_LEN
    ref_y, ref_sum = _chunked_prefill(
        bf(q), bf(k), bf(v), valid, jnp.int32(PROMPT_LEN), True, 16, 256
    )
    y, summary = _port(q, k, v)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref_y, np.float32),
                               rtol=8e-3, atol=8e-3)
    _check_summary(summary, ref_sum, rtol=2e-4)


@pytest.mark.parametrize("need_summary", [True, False])
def test_prefill_attention_routes_head_dim_128_to_the_kernel(need_summary):
    """``prefill_attention`` sends head_dim 128 and P % 64 == 0 to the K4
    wrapper (its plain version here, uncounted); other shapes take the
    chunked math."""
    q, k, v = (torch.from_numpy(a[..., :256, :]).to(torch.bfloat16) for a in _inputs(2))
    valid = torch.arange(256)[None, :] < 200
    before = prefill_attn.LAUNCHES["flash_prefill_summary"]
    y, summary = attention.prefill_attention(q, k, v, valid, 200, need_summary=need_summary)
    assert prefill_attn.LAUNCHES["flash_prefill_summary"] == before
    y2, s2 = prefill_attn.flash_prefill_plain(q, k, v, 200, need_summary=need_summary)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    assert (summary is None) == (not need_summary)
    assert prefill_attn.flash_prefill_supported((1, 4, 256, 128))
    assert not prefill_attn.flash_prefill_supported((1, 4, 256, 64))
    assert not prefill_attn.flash_prefill_supported((1, 4, 200, 128))


# ---------------------------------------------------------------------------
# K6: attention plus the FastGen profile
# ---------------------------------------------------------------------------

WINDOWS = (51, 128)  # two distinct window lengths, as a two-window menu gives


def test_profile_plain_matches_tpu_flash_profile_kernel():
    """K6's plain version against ``flash_profile(interpret=True)``: the raw
    accumulators cum and wcols within 5e-3 of max|cum| (the bound of the
    JAX package's own kernel-vs-XLA test), y within the two bf16 roundings
    of ``test_plain_matches_tpu_flash_kernel``."""
    from cold_compress_tpu.ops.pallas_prefill import flash_profile as jax_flash_profile

    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(B, h, P, D).astype(np.float32) / 8 for h in (H, KVH, KVH))
    plen = P - 37
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref_y, ref_cum, ref_w = jax_flash_profile(bf(q), bf(k), bf(v), jnp.int32(plen),
                                              window_lens=WINDOWS, interpret=True)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    before = prefill_attn.LAUNCHES["flash_profile"]
    y, cum, wcols = prefill_attn.flash_profile(*t, plen, window_lens=WINDOWS)
    assert prefill_attn.LAUNCHES["flash_profile"] == before  # CPU: the plain version
    assert wcols.shape == (2, B, KVH, P) and cum.shape == (B, KVH, P)
    scale = float(np.abs(np.asarray(ref_cum)).max())
    assert float(np.abs(cum.numpy() - np.asarray(ref_cum)).max()) < 5e-3 * scale
    assert float(np.abs(wcols.numpy() - np.asarray(ref_w)).max()) < 5e-3 * scale
    assert np.all(cum.numpy()[..., plen:] == 0.0)
    np.testing.assert_allclose(y.float().numpy()[:, :, :plen],
                               np.asarray(ref_y, np.float32)[:, :, :plen], rtol=2e-2, atol=2e-2)
    # The window sums are parts of cum: each is at most cum, and a window
    # as long as the prompt holds every row.
    assert bool((wcols <= cum + 1e-6).all())
    _, cum_full, w_full = prefill_attn.flash_profile(*t, plen, window_lens=(P,))
    torch.testing.assert_close(w_full[0], cum_full, rtol=1e-5, atol=1e-7)
