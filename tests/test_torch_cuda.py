"""On-card tests: each CUDA kernel of the port against its plain PyTorch
version, and the port on the card against the port on the CPU.

Marked ``cuda``; they skip (inside a fixture) where there is no card. On a
machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; these tests import only the port.)
"""

import numpy as np
import pytest
import torch

from cold_compress_tpu_torch.caches.base import quantize_rows
from cold_compress_tpu_torch.ops import decode_attn, prefill_attn, qmm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _assert_bf16_out_close(y, ref, row_share):
    """A bf16 attention output against its plain version, element by
    element: one bf16 unit (2**-7 of the element) where the two sides' f32
    values round apart, plus ``row_share`` of the row's largest element for
    the f32 differences between the two sides. Late prefill rows average
    thousands of keys and are small, so a bound on the tensor's largest
    element would not see a wrong row."""
    r = ref.float().abs()
    tol = 2**-7 * r + row_share * r.amax(-1, keepdim=True)
    err = (y.float() - ref.float()).abs()
    worst = float((err / tol.clamp_min(1e-30)).max())
    assert bool((err <= tol).all()), f"max err/tol {worst:.3f}"


@pytest.mark.parametrize("L", [1, 5, 32])
@pytest.mark.parametrize("IN,OUT,gs", [(512, 1000, 128), (1024, 384, 64), (14336, 256, 128)])
def test_w4a8_gemv_matches_plain(dev, L, IN, OUT, gs):
    """Ragged OUT (masked edge), several groups per lane step, and the
    w2-like depth. Exact integer group dots: only f32 order differs."""
    g = _gen(dev, L + IN)
    wg = torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev, generator=g)
    s = torch.rand((OUT, IN // gs), device=dev, generator=g) * 3e-3 + 1e-3
    z = (torch.rand((OUT, IN // gs), device=dev, generator=g) - 0.5) * 2e-2
    sz = torch.stack([s, z], -1).to(torch.bfloat16).contiguous()
    x = torch.randn((L, IN), device=dev, generator=g).to(torch.bfloat16)
    x[0, 0] = 0.0
    before = qmm.LAUNCHES["w4a8_gemv.wo"]
    y = qmm.w4a8_gemv(x, wg, sz, gs, counter="w4a8_gemv.wo")
    assert qmm.LAUNCHES["w4a8_gemv.wo"] == before + 1
    ref = qmm.w4a8_gemv_plain(x, wg, sz, gs)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_activation_quantization_matches_cpu(dev):
    """The plain version's int8 activations are the same bits on the card
    as on the CPU, where division is IEEE, as the kernel's ``__fdiv_rn`` is.
    CUDA turns a division by a Python scalar into a multiplication by its
    reciprocal; a plain version that divided by the scalar 127 moved some
    activations by one int8 unit and disagreed with the kernel."""
    x = torch.randn((32, 1024), device=dev, generator=_gen(dev, 9)).to(torch.bfloat16)
    xq, sx = qmm.quantize_activations(x)
    xq_c, sx_c = qmm.quantize_activations(x.cpu())
    assert torch.equal(sx.cpu(), sx_c) and torch.equal(xq.cpu(), xq_c)


def test_w4a8_gemv_rejects_what_it_does_not_take(dev):
    wg = torch.zeros((256, 256), dtype=torch.uint8, device=dev)
    sz = torch.zeros((256, 4, 2), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # f32 x
        qmm.w4a8_gemv(torch.zeros((1, 512), device=dev), wg, sz, 128, counter="w4a8_gemv.wo")
    with pytest.raises(ValueError):
        qmm.w4a8_gemv(torch.zeros((1, 512), dtype=torch.bfloat16, device=dev), wg[:, :128], sz,
                      128, counter="w4a8_gemv.wo")


@pytest.mark.parametrize("C,G", [(2048, 4), (300, 8), (128, 1)])
def test_kv8_decode_attention_matches_plain(dev, C, G):
    B, KVH, D = 2, 2, 128
    g = _gen(dev, C + G)
    kq, ks, kz = quantize_rows(torch.randn((B, KVH, C, D), device=dev, generator=g), 8)
    vq, vs, vz = quantize_rows(torch.randn((B, KVH, C, D), device=dev, generator=g), 8)
    mask = torch.rand((B, KVH, C), device=dev, generator=g) > 0.3
    mask[1, 1] = False  # a head with no valid slot: uniform, as the TPU kernel
    mask[0, 0, 128:256] = False  # one whole 128-slot chunk of the kernel's split
    q = (torch.randn((B, KVH * G, 1, D), device=dev, generator=g) / 4).to(torch.bfloat16)
    out, pooled = decode_attn.kv8_decode_attention(q, kq, vq, ks, kz, vs, vz, mask)
    ref_out, ref_pooled = decode_attn.kv8_decode_attention_plain(q, kq, vq, ks, kz, vs, vz, mask)
    # Same roundings on both sides; only the order of the f32 sums differs.
    _assert_bf16_out_close(out, ref_out, 2**-8)
    torch.testing.assert_close(pooled, ref_pooled, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("P,plen,G", [(256, 200, 4), (512, 512, 2), (1024, 77, 8)])
def test_flash_prefill_matches_plain(dev, P, plen, G):
    B, KVH, D = 2, 2, 128
    g = _gen(dev, P + G)
    q = torch.randn((B, KVH * G, P, D), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=g).to(torch.bfloat16)
    y, s = prefill_attn.flash_prefill(q, k, v, plen, need_summary=True)
    ref_y, ref_s = prefill_attn.flash_prefill_plain(q, k, v, plen, need_summary=True)
    # Unnormalised (kernel) vs normalised (plain) probabilities to bf16:
    # each moves by up to 2**-9 on each side; over many keys these moves
    # mostly cancel and stay well under 2**-7 of the row's largest element.
    _assert_bf16_out_close(y, ref_y, 2**-7)
    for key in ("obs_mean", "cum_mean"):
        torch.testing.assert_close(s[key], ref_s[key], rtol=1e-4, atol=1e-6)
    y2, none = prefill_attn.flash_prefill(q, k, v, plen, need_summary=False)
    assert none is None
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


def test_generate_on_card_matches_cpu(dev):
    """TestKernel, int4 weights and head, kv8 heavy-hitter, teacher-forced:
    the port on the card (kernels) against the port on the CPU (plain)."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
    from cold_compress_tpu_torch.runtime.generate import generate

    cfg = ModelConfig.from_name("TestKernel")
    flat = random_quantized_params(cfg, seed=0)
    specs = build_cache_specs(cfg, {
        "cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25],
        "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
        "recent_window": 10, "cache_bits": 8}, 512)
    prompt = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    forced = np.random.RandomState(1).randint(2, 500, size=8).tolist()
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, params_from_flat(flat, device), device, max_positions=512)
        caches = init_caches(cfg, specs, 1, torch.bfloat16, device=device)
        reset_kernel_launches()
        _, info, _ = generate(model, caches, prompt, 8, prefill_bucket=512, next_tokens=forced)
        out[device] = (np.asarray(info["emitted_probs"]), kernel_launches())
    e_g, launches = out["cuda"]
    e_c, _ = out["cpu"]
    np.testing.assert_allclose(e_g, e_c, rtol=2e-2)
    assert launches["flash_prefill_summary"] == cfg.n_layer
    assert launches["kv8_decode_attention"] == cfg.n_layer * 7
    assert launches["w4a8_gemv.head"] == 8
