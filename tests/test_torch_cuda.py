"""On-card tests: each CUDA kernel of the port against its plain PyTorch
version, and the port on the card against the port on the CPU.

Marked ``cuda``; they skip (inside a fixture) where there is no card. On a
machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; these tests import only the port.)
"""

import functools

import numpy as np
import pytest
import torch

from cold_compress_tpu_torch.caches.base import quantize_rows
from cold_compress_tpu_torch.ops import decode_attn, evict, prefill_attn, qmm

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


def _gemv_inputs(dev, seed, L, IN, OUT, gs):
    g = _gen(dev, seed)
    wg = torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev, generator=g)
    s = torch.rand((OUT, IN // gs), device=dev, generator=g) * 3e-3 + 1e-3
    z = (torch.rand((OUT, IN // gs), device=dev, generator=g) - 0.5) * 2e-2
    sz = torch.stack([s, z], -1).to(torch.bfloat16).contiguous()
    x = torch.randn((L, IN), device=dev, generator=g).to(torch.bfloat16)
    return x, wg, sz


@pytest.mark.parametrize("cols", qmm.GEMV_COLS)
@pytest.mark.parametrize("L,gs", [(1, 64), (3, 128), (32, 64), (32, 128)])
def test_w4a8_gemv_every_tile_matches_plain(dev, cols, L, gs):
    """Every column tile, with a ragged OUT, group size 64 and up to 32
    rows."""
    IN, OUT = 2048, 1000
    x, wg, sz = _gemv_inputs(dev, cols + L + gs, L, IN, OUT, gs)
    y = qmm.w4a8_gemv(x, wg, sz, gs, counter="w4a8_gemv.wo", cols=cols)
    ref = qmm.w4a8_gemv_plain(x, wg, sz, gs)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-4 * float(ref.abs().max()) + 1e-6)


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("gs", [32, 256, 512, 1024])
@pytest.mark.parametrize("IN,OUT", [(4096, 1000), (14336, 1000)])
def test_w4a8_gemv_every_group_size_matches_plain(dev, IN, OUT, gs, L):
    """The group sizes the wrapper takes beyond the 8B configurations' 64 and
    128: four groups per lane (32), and groups over 2, 4 or 8 lanes whose
    sums span warps in the prologue (256 to 1024; 14336 = 14 * 1024), at one
    row and at two row blocks, with a ragged OUT."""
    x, wg, sz = _gemv_inputs(dev, IN + gs + L, L, IN, OUT, gs)
    y = qmm.w4a8_gemv(x, wg, sz, gs, counter="w4a8_gemv.wo")
    ref = qmm.w4a8_gemv_plain(x, wg, sz, gs)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-4 * float(ref.abs().max()) + 1e-6)


@pytest.mark.parametrize("L,IN", [(1, 18432), (2, 18432), (1, 16384)])
def test_w4a8_gemv_long_rows_match_plain(dev, L, IN):
    """Rows longer than the kernel holds in registers (above 16384 inputs,
    or more than one row) take its loading prologue."""
    x, wg, sz = _gemv_inputs(dev, L + IN, L, IN, 1000, 128)
    y = qmm.w4a8_gemv(x, wg, sz, 128, counter="w4a8_gemv.wo")
    ref = qmm.w4a8_gemv_plain(x, wg, sz, 128)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-4 * float(ref.abs().max()) + 1e-6)


@pytest.mark.parametrize("IN,OUT", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                                    (4096, 1024), (4096, 128256)])
def test_w4a8_gemv_is_deterministic(dev, IN, OUT):
    """Two launches on the same inputs give the same bits, at the main
    path's shapes and their default partition."""
    x, wg, sz = _gemv_inputs(dev, IN ^ OUT, 1, IN, OUT, 128)
    a = qmm.w4a8_gemv(x, wg, sz, 128, counter="w4a8_gemv.wo")
    b = qmm.w4a8_gemv(x, wg, sz, 128, counter="w4a8_gemv.wo")
    assert torch.equal(a, b)
    # More tiles than CTAs at these shapes: each CTA walks several.
    ref = qmm.w4a8_gemv_plain(x, wg, sz, 128)
    torch.testing.assert_close(a, ref, rtol=0, atol=1e-4 * float(ref.abs().max()) + 1e-6)


def test_activation_quantization_matches_cpu(dev):
    """The plain version's int8 activations are the same bits on the card
    as on the CPU: ``sx`` is a multiplication by the f32 reciprocal of 127
    (as XLA computes ``/ 127.0``) and ``x / sx`` an IEEE division on both,
    as in the kernels' prologue (``csrc/act_quant.cuh``)."""
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
    args = (q, kq, vq, ks, kz, vs, vz, mask)
    out, pooled = decode_attn.decode_attention(*args, bits=8, need_attn=True)
    ref_out, ref_pooled = decode_attn.decode_attention_plain(*args, 8, True)
    # Same roundings on both sides; only the order of the f32 sums differs.
    _assert_bf16_out_close(out, ref_out, 2**-8)
    torch.testing.assert_close(pooled, ref_pooled, rtol=1e-5, atol=1e-7)


def _cache(dev, g, bits, B, KVH, C, D=128):
    """Random K or V rows at one precision: (rows, scales, zeros)."""
    x = torch.randn((B, KVH, C, D), device=dev, generator=g)
    if bits == 16:
        return x.to(torch.bfloat16), None, None
    return quantize_rows(x, bits)


@pytest.mark.parametrize("need_attn", [True, False])
@pytest.mark.parametrize("bits", [16, 8, 4, 2])
@pytest.mark.parametrize("C,G", [(2048, 4), (300, 8), (4096, 1)])
def test_decode_attention_matches_plain(dev, bits, need_attn, C, G):
    """Every cache precision, with and without pooled probabilities; a
    ragged last chunk (C = 300), a masked whole chunk and a head with no
    valid slot."""
    B, KVH, D = 2, 2, 128
    g = _gen(dev, bits * 1000 + C + G)
    kc, ks, kz = _cache(dev, g, bits, B, KVH, C)
    vc, vs, vz = _cache(dev, g, bits, B, KVH, C)
    mask = torch.rand((B, KVH, C), device=dev, generator=g) > 0.3
    mask[1, 1] = False
    mask[0, 0, 128:256] = False
    q = (torch.randn((B, KVH * G, 1, D), device=dev, generator=g) / 4).to(torch.bfloat16)
    args = (q, kc, vc, ks, kz, vs, vz, mask)
    name = decode_attn.variant(bits, need_attn)
    before = decode_attn.LAUNCHES[name]
    out, pooled = decode_attn.decode_attention(*args, bits=bits, need_attn=need_attn)
    assert decode_attn.LAUNCHES[name] == before + 1
    ref_out, ref_pooled = decode_attn.decode_attention_plain(*args, bits, need_attn)
    # Same roundings on both sides; only the order of the f32 sums differs.
    _assert_bf16_out_close(out, ref_out, 2**-8)
    if need_attn:
        torch.testing.assert_close(pooled, ref_pooled, rtol=1e-5, atol=1e-7)
    else:
        assert pooled is None and ref_pooled is None


def _decode_case(dev, seed, bits, B, KVH, C, G):
    g = _gen(dev, seed)
    kc, ks, kz = _cache(dev, g, bits, B, KVH, C)
    vc, vs, vz = _cache(dev, g, bits, B, KVH, C)
    mask = torch.rand((B, KVH, C), device=dev, generator=g) > 0.3
    if C > 1:
        mask[0, 0, : C // 2] = False  # a CTA range or more with no valid slot
    q = (torch.randn((B, KVH * G, 1, 128), device=dev, generator=g) / 4).to(torch.bfloat16)
    return (q, kc, vc, ks, kz, vs, vz, mask)


def _assert_decode_matches_plain(args, bits, need_attn, cluster=None):
    out, pooled = decode_attn.decode_attention(*args, bits=bits, need_attn=need_attn,
                                               cluster=cluster)
    ref_out, ref_pooled = decode_attn.decode_attention_plain(*args, bits, need_attn)
    assert out.dtype == args[0].dtype
    _assert_bf16_out_close(out, ref_out, 2**-8)
    if need_attn:
        torch.testing.assert_close(pooled, ref_pooled, rtol=1e-5, atol=1e-7)
    return out, pooled


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("C", [1, 127, 129, 300, 1024, 1025, 2048, 2049, 4093, 32768])
def test_decode_attention_cluster_shapes(dev, C, G, bits):
    """One launch over every cluster size the cache lengths give (1, 2, 3,
    8, 9 and 16 CTAs, ragged ranges, C = 1), at B = 2; pooled where the
    cache is kv8."""
    args = _decode_case(dev, C + 10 * G + bits, bits, 2, 2, C, G)
    _assert_decode_matches_plain(args, bits, need_attn=bits == 8)


@pytest.mark.parametrize("bits,need_attn", [(16, False), (8, True), (4, True), (2, False)])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_decode_attention_explicit_cluster(dev, bits, need_attn, cluster):
    """The same answer whatever the cluster size; one CTA over 4096 slots
    of 8 heads keeps its scores in the global workspace."""
    C, G = 4096, 8
    assert decode_attn.scores_in_smem(C, G, cluster) == (cluster > 1)
    args = _decode_case(dev, 77 + cluster, bits, 2, 2, C, G)
    _assert_decode_matches_plain(args, bits, need_attn, cluster=cluster)


def test_decode_attention_global_workspace_by_default(dev):
    """C = 131072 at G = 8: 16 CTAs of 8192 slots, scores in the workspace."""
    C, G = 131072, 8
    assert not decode_attn.scores_in_smem(C, G, decode_attn.cluster_size(C))
    args = _decode_case(dev, 5, 16, 1, 1, C, G)
    _assert_decode_matches_plain(args, 16, True)


@pytest.mark.parametrize("bits,need_attn", [(16, False), (8, True), (4, False), (2, True)])
def test_decode_attention_is_deterministic(dev, bits, need_attn):
    """Two calls on the same inputs give the same bits (fixed sum order)."""
    args = _decode_case(dev, 3, bits, 1, 8, 32768, 4)
    a = decode_attn.decode_attention(*args, bits=bits, need_attn=need_attn)
    b = decode_attn.decode_attention(*args, bits=bits, need_attn=need_attn)
    assert torch.equal(a[0], b[0])
    if need_attn:
        assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("bits,need_attn,C,G,B,KVH", [
    (8, True, 2048, 4, 1, 8), (8, False, 2048, 4, 1, 8), (4, True, 2048, 4, 1, 8),
    (4, False, 2048, 4, 1, 8), (2, True, 2048, 4, 1, 8), (2, False, 2048, 4, 1, 8),
    (8, False, 32768, 4, 1, 8), (4, False, 32768, 4, 1, 8),
    (8, True, 300, 8, 2, 2), (4, False, 300, 8, 2, 2), (2, True, 4093, 1, 2, 2),
    (8, True, 1, 4, 2, 2),
])
def test_i8dot_decode_attention_matches_plain(dev, bits, need_attn, C, G, B, KVH):
    """The i8dot variant at the 8B decode shapes (C = 2048 at every
    precision, C = 32768), a ragged last tile, one slot, and G = 1 and 8,
    against ``decode_attention_i8dot_plain``: the int32 dots are exact on
    both sides, so only f32 order (and with it a rounding tie of the int8
    probabilities) differs. It counts its own launches, never the
    dequantizing variant's."""
    args = _decode_case(dev, 900 + bits + C + G, bits, B, KVH, C, G)
    name, other = (decode_attn.variant(bits, need_attn, True),
                   decode_attn.variant(bits, need_attn, False))
    before = dict(decode_attn.LAUNCHES)
    out, pooled = decode_attn.decode_attention(*args, bits=bits, need_attn=need_attn, i8dot=True)
    assert decode_attn.LAUNCHES[name] == before[name] + 1
    assert decode_attn.LAUNCHES[other] == before[other]
    ref_out, ref_pooled = decode_attn.decode_attention_i8dot_plain(*args, bits, need_attn)
    _assert_bf16_out_close(out, ref_out, 2**-8)
    if need_attn:
        torch.testing.assert_close(pooled, ref_pooled, rtol=1e-5, atol=1e-7)
    again = decode_attn.decode_attention(*args, bits=bits, need_attn=need_attn, i8dot=True)
    assert torch.equal(out, again[0]) and (not need_attn or torch.equal(pooled, again[1]))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_i8dot_decode_attention_explicit_cluster(dev, bits, cluster):
    """The i8dot variant's probability scale is a maximum over the whole
    cluster: the same answer against the plain version at any cluster size
    (one CTA over 4096 slots keeps its scores in the global workspace)."""
    args = _decode_case(dev, 177 + cluster, bits, 2, 2, 4096, 8)
    out, pooled = decode_attn.decode_attention(*args, bits=bits, need_attn=True, i8dot=True,
                                               cluster=cluster)
    ref_out, ref_pooled = decode_attn.decode_attention_i8dot_plain(*args, bits, True)
    _assert_bf16_out_close(out, ref_out, 2**-8)
    torch.testing.assert_close(pooled, ref_pooled, rtol=1e-5, atol=1e-7)


def test_decode_attention_rejects_what_it_does_not_take(dev):
    B, KVH, C = 1, 2, 256
    g = _gen(dev, 5)
    kc, ks, kz = _cache(dev, g, 4, B, KVH, C)
    mask = torch.ones((B, KVH, C), dtype=torch.bool, device=dev)
    q = torch.zeros((B, 4, 1, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # packed int4 rows read as int8
        decode_attn.decode_attention(q, kc, kc, ks, kz, ks, kz, mask, bits=8, need_attn=True)
    with pytest.raises(ValueError):  # head_dim 64
        decode_attn.decode_attention(q[..., :64], kc, kc, ks, kz, ks, kz, mask, bits=4,
                                     need_attn=True)
    with pytest.raises(ValueError):  # missing scales
        decode_attn.decode_attention(q, kc, kc, None, kz, ks, kz, mask, bits=4, need_attn=True)
    kb = torch.zeros((B, KVH, C, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="i8dot"):  # integer branch over a bf16 cache
        decode_attn.decode_attention(q, kb, kb, None, None, None, None, mask, bits=16,
                                     need_attn=True, i8dot=True)


@pytest.mark.parametrize("B,H,C", [(1, 8, 2048), (2, 3, 300), (1, 2, 4096)])
def test_hh_evict_matches_plain_bit_for_bit(dev, B, H, C):
    """Same slot, same zeroed history: ties (dyadic averages, protected and
    empty slots) included."""
    g = _gen(dev, B * C + H)
    num = (torch.randint(0, 8, (B, H, C), device=dev, generator=g) / 4.0).float()
    denom = torch.randint(0, 5, (B, H, C), device=dev, generator=g, dtype=torch.int32)
    pos = torch.randperm(C, device=dev, generator=g).to(torch.int32).expand(B, H, C).clone()
    if C == 300:  # empty slots are evicted first
        pos[:, :, -7:] = -1
    ipos = torch.full((B, 1, 1), C + 3, dtype=torch.int32, device=dev)
    n1, d1 = num.clone(), denom.clone()
    n2, d2 = num.cpu(), denom.cpu()
    idx = evict.hh_evict(n1, d1, pos, ipos, global_tokens=4, recent_window=10)
    ref = evict.hh_evict_plain(n2, d2, pos.cpu(), ipos.cpu(), 4, 10)
    assert torch.equal(idx.cpu(), ref)
    assert torch.equal(n1.cpu(), n2) and torch.equal(d1.cpu(), d2)


@pytest.mark.parametrize("C", [2047, 2048, 301, 3, 1])
def test_hh_evict_any_row_alignment_bit_for_bit(dev, C):
    """B = 2: with C % 4 != 0 every row but the first starts off a 16-byte
    boundary, so the kernel's scalar head and tail take part; ties, empty
    and protected slots included, and the minimum put at the row's edges."""
    B, H = 2, 8
    g = _gen(dev, C)
    num = (torch.randint(1, 8, (B, H, C), device=dev, generator=g) / 4.0).float()
    denom = torch.randint(0, 5, (B, H, C), device=dev, generator=g, dtype=torch.int32)
    pos = torch.stack([torch.randperm(C, device=dev, generator=g) for _ in range(B * H)])
    pos = pos.reshape(B, H, C).to(torch.int32) + 8  # nothing global, every average > 0
    if C > 8:
        num[0, 1, 0] = -1.0   # the first slot of a misaligned row
        num[1, 2, -1] = -1.0  # the last slot of another
        pos[1, 3, C // 2] = -1
    ipos = torch.full((B, 1, 1), C + 64, dtype=torch.int32, device=dev)
    n1, d1 = num.clone(), denom.clone()
    n2, d2 = num.cpu(), denom.cpu()
    idx = evict.hh_evict(n1, d1, pos, ipos, global_tokens=4, recent_window=10)
    ref = evict.hh_evict_plain(n2, d2, pos.cpu(), ipos.cpu(), 4, 10)
    assert torch.equal(idx.cpu(), ref)
    assert torch.equal(n1.cpu().view(torch.int32), n2.view(torch.int32))
    assert torch.equal(d1.cpu(), d2)
    if C > 8:
        assert int(idx[0, 1]) == 0 and int(idx[1, 2]) == C - 1 and int(idx[1, 3]) == C // 2


@pytest.mark.parametrize("thresholding", [False, True])
def test_heavy_hitter_one_slot_history_evicts_through_kernel(dev, thresholding):
    """A one-slot heavy-hitter history evicts through K7, thresholded or
    not, and keeps the same slots and history as on the CPU."""
    from cold_compress_tpu_torch.caches import base, get_cache_strategy

    B, KVH, D, P, steps = 1, 2, 128, 10, 20
    spec = base.CacheSpec(cache_strategy="heavy_hitter", max_cache_length=16,
                          max_seq_length=64, global_tokens=2, recent_window=3, cache_bits=8,
                          attn_thresholding=thresholding)
    strat = get_cache_strategy("heavy_hitter")
    rng = np.random.RandomState(int(thresholding))
    k, v = (torch.from_numpy(rng.randn(B, KVH, P + steps, D).astype(np.float32))
            for _ in range(2))
    attn = torch.from_numpy(rng.rand(steps + 1, B, KVH, 16).astype(np.float32))
    pos = torch.arange(P, dtype=torch.int32).expand(B, KVH, P)
    valid = torch.ones((B, KVH, P), dtype=torch.bool)
    states = {}
    for d in (dev, torch.device("cpu")):
        s = strat.init(spec, B, KVH, D, device=d)
        base.prefill_update(strat, s, pos.to(d), k[:, :, :P].to(d), v[:, :, :P].to(d),
                            valid.to(d))
        strat.update_state(spec, s, None, attn[0, ..., :P].to(d), is_prefill=True)
        states[d.type] = s
    before = evict.LAUNCHES["hh_evict"]
    for step in range(steps):
        ipos = P + step
        for d, s in states.items():
            kr, vr = (t[:, :, ipos:ipos + 1].to(d) for t in (k, v))
            base.decode_update(strat, s, ipos, kr, vr)
            strat.update_state(spec, s, ipos, attn[step + 1].to(d) * s.mask, is_prefill=False)
    # One launch per step: the slot is chosen by K7 whether the cache is
    # full or still has empty slots (taken first).
    assert evict.LAUNCHES["hh_evict"] == before + steps
    g, c = states["cuda"], states["cpu"]
    assert torch.equal(g.pos.cpu(), c.pos)
    assert torch.equal(g.extra["attn_num"].cpu(), c.extra["attn_num"])
    assert torch.equal(g.extra["attn_denom"].cpu(), c.extra["attn_denom"])


@pytest.mark.parametrize("cols", [None, *qmm.GEMV_COLS])
@pytest.mark.parametrize("L", [1, 4, 5, 7, 32])
@pytest.mark.parametrize("IN,OUT", [(4096, 1000), (256, 512), (1040, 333), (14336, 1000)])
def test_w8a8_gemv_matches_plain_bit_for_bit(dev, L, IN, OUT, cols):
    """Exact int32 dots on both sides and the same f32 epilogue order: the
    outputs are the same bits. Ragged OUT is masked; IN not a multiple of
    the kernel's 2048-input piece (1040, 14336) ends in a partial piece;
    every column tile (``cols``, or the partition's choice), at one row,
    one row block, and several (with a partial last one)."""
    g = _gen(dev, L + IN + OUT)
    w = torch.randint(-127, 128, (IN, OUT), dtype=torch.int8, device=dev, generator=g)
    s = torch.rand((OUT,), device=dev, generator=g) * 1e-3
    wt, st = qmm.int8_to_gemv(w, s)
    x = torch.randn((L, IN), device=dev, generator=g).to(torch.bfloat16)
    before = qmm.LAUNCHES["w8a8_gemv.head"]
    y = qmm.w8a8_gemv(x, wt, st, counter="w8a8_gemv.head", cols=cols)
    assert qmm.LAUNCHES["w8a8_gemv.head"] == before + 1
    ref = qmm.w8a8_gemv_plain(x, wt, st)
    assert torch.equal(y, ref), float((y - ref).abs().max())
    with pytest.raises(ValueError):
        qmm.w8a8_gemv(x.float(), wt, st, counter="w8a8_gemv.head")
    with pytest.raises(ValueError):  # a tile width the kernel has no instance of
        qmm.w8a8_gemv(x, wt, st, counter="w8a8_gemv.head", cols=48)


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


@pytest.mark.parametrize("G", [2, 4, 8])
@pytest.mark.parametrize("P,plen,B,KVH", [(64, 50, 2, 2), (1024, 1000, 2, 2),
                                          (8192, 7928, 1, 1)])
def test_flash_prefill_shapes_and_determinism(dev, P, plen, B, KVH, G):
    """K4 over pass 2's segment cuts (one segment at P = 64, 32 at 8192),
    against its plain version; a second call gives the same bits."""
    g = _gen(dev, 3 * P + G)
    q = torch.randn((B, KVH * G, P, 128), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, 128), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, 128), device=dev, generator=g).to(torch.bfloat16)
    y, s = prefill_attn.flash_prefill(q, k, v, plen, need_summary=True)
    ref_y, ref_s = prefill_attn.flash_prefill_plain(q, k, v, plen, need_summary=True)
    _assert_bf16_out_close(y, ref_y, 2**-7)
    for key in ("obs_mean", "cum_mean"):
        tol = 1e-4 * float(ref_s[key].abs().max()) + 1e-7
        torch.testing.assert_close(s[key], ref_s[key], rtol=0, atol=tol)
    y2, s2 = prefill_attn.flash_prefill(q, k, v, plen, need_summary=True)
    assert torch.equal(y, y2)
    assert all(torch.equal(s[key], s2[key]) for key in s)


def test_flash_profile_is_deterministic(dev):
    g = _gen(dev, 11)
    q = torch.randn((1, 8, 2048, 128), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((1, 2, 2048, 128), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((1, 2, 2048, 128), device=dev, generator=g).to(torch.bfloat16)
    a = prefill_attn.flash_profile(q, k, v, 2000, window_lens=(100, 600))
    b = prefill_attn.flash_profile(q, k, v, 2000, window_lens=(100, 600))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_generate_on_card_matches_cpu(dev):
    """TestKernel, int4 weights and head, kv8 heavy-hitter, teacher-forced:
    the port on the card (kernels) against the port on the CPU (plain);
    decode attention in the i8dot branch (``auto`` at C = 128, as the TPU
    program routes it)."""
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
    assert launches["decode_attention.kv8.i8dot"] == cfg.n_layer * 7
    assert "decode_attention.kv8" not in launches or launches["decode_attention.kv8"] == 0
    assert launches["hh_evict"] == cfg.n_layer * 7
    assert launches["w4a8_gemv.head"] == 8


def test_generate_stops_at_terminator_on_card_as_on_cpu(dev):
    """TestKernel, int4 weights and head, kv8 heavy-hitter, greedy on the
    card with its own third token declared a terminator: it stops after the
    step that emits it, and the CPU, forced through the same tokens, runs
    as many steps and leaves the same cache_ct in every layer (the CPU is
    forced because random weights give near-ties that may flip a greedy
    token between the two)."""
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
    models = {d: build_model(cfg, params_from_flat(flat, d), d, max_positions=512)
              for d in ("cuda", "cpu")}

    def caches(device):
        return init_caches(cfg, specs, 1, torch.bfloat16, device=device)

    seq, _, _ = generate(models["cuda"], caches("cuda"), prompt, 8, prefill_bucket=512)
    gen = seq[len(prompt):]
    k = gen.index(gen[2], 1)  # the first decode step that emits it
    reset_kernel_launches()
    seq_g, info_g, caches_g = generate(models["cuda"], caches("cuda"), prompt, 8,
                                       prefill_bucket=512, terminator_ids=[gen[2]])
    launches = kernel_launches()
    assert seq_g == prompt + gen[:k + 1] and info_g["perf_stats"]["decode_steps"] == k
    assert launches["hh_evict"] == cfg.n_layer * k and launches["w4a8_gemv.head"] == k + 1
    _, info_c, caches_c = generate(models["cpu"], caches("cpu"), prompt, 8, prefill_bucket=512,
                                   next_tokens=gen[:k + 1])
    assert info_c["perf_stats"]["decode_steps"] == k
    assert all(torch.equal(g.cache_ct.cpu(), c.cache_ct) for g, c in zip(caches_g, caches_c))
    assert all(torch.equal(g.pos.cpu() >= 0, c.pos >= 0) for g, c in zip(caches_g, caches_c))


def test_generate_batch_graph_is_bit_equal_to_eager_and_lanes_stop(dev):
    """TestKernel, int4 weights and head, kv8 heavy-hitter, three lanes of
    300, 280 and 260 tokens: ``generate_batch`` through the captured graph
    equals the eager step bit for bit (tokens, probabilities, every cache
    tensor); with lane 0's third token as a terminator, lane 0 stops there
    and the others run on as before unless they emit it."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs, build_model, params_from_flat
    from cold_compress_tpu_torch.runtime.generate import generate_batch

    cfg = ModelConfig.from_name("TestKernel")
    model = build_model(cfg, params_from_flat(random_quantized_params(cfg, seed=0), dev), dev,
                        max_positions=512)
    specs = build_cache_specs(cfg, {
        "cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25],
        "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
        "recent_window": 10, "cache_bits": 8}, 512)
    base = np.random.RandomState(0).randint(2, 500, size=300).tolist()
    prompts = [base, base[:280], np.random.RandomState(4).randint(2, 500, size=260).tolist()]
    out = {}
    for graph in (True, False):
        caches = init_caches(cfg, specs, 3, torch.bfloat16, device=dev)
        seqs, info, caches = generate_batch(model, caches, prompts, 8, prefill_bucket=512,
                                            cuda_graph=graph)
        out[graph] = (seqs, info, [t.cpu() for c in caches for t in c.tensors()])
    (seqs, info, tensors), (seqs_e, info_e, tensors_e) = out[True], out[False]
    assert info["decode_graph"]["captured"] and info_e["decode_graph"] is None
    assert seqs == seqs_e and info["emitted_probs"] == info_e["emitted_probs"]
    assert np.array_equal(info["final_probs"], info_e["final_probs"])
    assert all(torch.equal(a, b) for a, b in zip(tensors, tensors_e))
    term = seqs[0][300 + 2]
    caches = init_caches(cfg, specs, 3, torch.bfloat16, device=dev)
    stopped, info_t, _ = generate_batch(model, caches, prompts, 8, prefill_bucket=512,
                                        terminator_ids=[term])
    k = seqs[0][300:].index(term, 1)  # the first decode step that emits it
    assert stopped[0] == seqs[0][: 300 + k + 1]
    for b in (1, 2):
        if term not in seqs[b][len(prompts[b]) + 1:]:  # a first token never stops a lane
            assert stopped[b] == seqs[b]


@pytest.mark.parametrize("P,plen,G,windows", [
    (256, 200, 4, (51,)), (512, 475, 2, (51, 128)), (1024, 77, 8, ()),
    (512, 512, 4, (1, 30, 200, 512)), (2048, 1900, 4, (7, 64, 1000)),
])
def test_flash_profile_matches_plain(dev, P, plen, G, windows):
    """K6 against its plain version: y as K4's; the raw profile sums to
    1e-4 of their largest value (f32 order only). No window, and four."""
    B, KVH, D = 2, 2, 128
    g = _gen(dev, P + G + len(windows))
    q = torch.randn((B, KVH * G, P, D), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((B, KVH, P, D), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((B, KVH, P, D), device=dev, generator=g).to(torch.bfloat16)
    before = prefill_attn.LAUNCHES["flash_profile"]
    y, cum, wcols = prefill_attn.flash_profile(q, k, v, plen, window_lens=windows)
    assert prefill_attn.LAUNCHES["flash_profile"] == before + 1
    ref_y, ref_cum, ref_w = prefill_attn.flash_profile_plain(q, k, v, plen, windows)
    _assert_bf16_out_close(y, ref_y, 2**-7)
    tol = 1e-4 * float(ref_cum.abs().max())
    torch.testing.assert_close(cum, ref_cum, rtol=0, atol=tol)
    assert wcols.shape == (len(windows), B, KVH, P)
    torch.testing.assert_close(wcols, ref_w, rtol=0, atol=tol)
    with pytest.raises(ValueError):  # five windows
        prefill_attn.flash_profile(q, k, v, plen, window_lens=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("L", [33, 256, 1000, 7928])
@pytest.mark.parametrize("IN,OUT,gs", [(512, 1000, 128), (1024, 384, 64), (14336, 256, 128),
                                       (256, 200, 32), (512, 136, 256), (2048, 1000, 128)])
def test_w4a8_gemm_matches_plain(dev, L, IN, OUT, gs):
    """K8 against K1's plain version: ragged rows (the main path's 7928-token
    prompt among them) and columns (OUT not a multiple of the 128-column
    tile), every group size it takes and so every instance (a flush every
    32 or 64 inputs, every 128 with the zero term on the CUDA cores (IN =
    512) or on the tensor cores (IN = 2048, 14336: blocks of eight groups),
    every 256). Exact integer group dots: only f32 order differs. Two
    launches give the same bits."""
    g = _gen(dev, 7 * L + IN + gs)
    wg = torch.randint(0, 256, (OUT, IN // 2), dtype=torch.uint8, device=dev, generator=g)
    s = torch.rand((OUT, IN // gs), device=dev, generator=g) * 3e-3 + 1e-3
    z = (torch.rand((OUT, IN // gs), device=dev, generator=g) - 0.5) * 2e-2
    sz = torch.stack([s, z], -1).to(torch.bfloat16).contiguous()
    x = torch.randn((L, IN), device=dev, generator=g).to(torch.bfloat16)
    x[0] = 0.0  # an all-zero row: sx at its 1e-8 floor
    before = qmm.LAUNCHES["w4a8_gemm.w2"]
    y = qmm.w4a8_gemm(x, wg, sz, gs, counter="w4a8_gemm.w2")
    assert qmm.LAUNCHES["w4a8_gemm.w2"] == before + 1
    ref = qmm.w4a8_gemv_plain(x, wg, sz, gs)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-4 * float(ref.abs().max()) + 1e-6)
    assert torch.equal(y, qmm.w4a8_gemm(x, wg, sz, gs, counter="w4a8_gemm.w2"))
    with pytest.raises(ValueError):  # a group size it does not take
        qmm.w4a8_gemm(x, wg[:, : IN // 2], sz, 48, counter="w4a8_gemm.w2")


def test_hybrid_decode_update_on_card_matches_cpu(dev):
    """The hybrid fill and 24 vectorised decode steps (kv8, dropping,
    evicting and punctuation-tracking heads) leave the same state on the
    card as on the CPU, bit for bit."""
    from cold_compress_tpu_torch.caches import base, get_cache_strategy
    from cold_compress_tpu_torch.caches.hybrid import normalize_hybrid_strategies

    B, KVH, P, D = 2, 4, 96, 128
    menu = normalize_hybrid_strategies([
        {"strategy": "special_punc"}, {"strategy": "window", "recent_window": 0.1},
        {"strategy": "window_heavy_hitter", "recent_window": 0.3, "heavy_hitter_frac": 0.25},
        {"strategy": "full"}])
    spec = base.CacheSpec(cache_strategy="hybrid", max_cache_length=P, max_seq_length=P,
                          global_tokens=3, cache_bits=8, hybrid_strategies=menu,
                          token_ids_special=((5,),), token_ids_punc=(46, 44))
    strat = get_cache_strategy("hybrid")
    rng = np.random.RandomState(3)
    k, v = (torch.from_numpy(rng.randn(B, KVH, P + 24, D).astype(np.float32)) for _ in range(2))
    cum = torch.from_numpy(rng.rand(B, KVH, P).astype(np.float32))
    wcols = torch.from_numpy(rng.rand(2, B, KVH, P).astype(np.float32)) * cum
    toks = torch.from_numpy(rng.choice([5, 46, 44, 9, 10, 11], size=(B, P)))
    plen = torch.tensor([80, 70], dtype=torch.int32)
    valid = torch.arange(P)[None] < plen[:, None]
    sidx = torch.tensor([[0, 1, 2, 3], [1, 2, 0, 3]], dtype=torch.int32)
    # The fill on the CPU, copied to the card: the steps start equal.
    cpu = strat.init(spec, B, KVH, D, device="cpu")
    strat.fill_after_profile(spec, cpu, cum, wcols, k[:, :, :P], v[:, :, :P], toks,
                             torch.arange(P), valid, plen)
    cpu.extra["strategy_idx"].copy_(sidx)  # every policy, whatever the profile chose
    card = strat.init(spec, B, KVH, D, device=dev)
    for t_g, t_c in zip(card.tensors(), cpu.tensors()):
        t_g.copy_(t_c)
    states = {"cuda": card, "cpu": cpu}
    for step in range(24):
        attn = torch.from_numpy(rng.rand(B, KVH, P).astype(np.float32))
        tok = torch.tensor([46 if step % 3 == 0 else 9, 10])
        for name, s in states.items():
            d = torch.device(name)
            kr, vr = (t[:, :, P + step:P + step + 1].to(d) for t in (k, v))
            base.decode_update(strat, s, 80 + step, kr, vr, token=tok.to(d))
            strat.update_state(spec, s, 80 + step, attn.to(d) * s.mask, is_prefill=False)
    g, c = states["cuda"], states["cpu"]
    for t_g, t_c in zip(g.tensors(), c.tensors()):
        assert torch.equal(t_g.cpu(), t_c)


@pytest.mark.parametrize("IN,OUT", [(4096, 1024), (288, 96), (14336, 256)])
def test_weight_quantization_on_card_matches_cpu(dev, IN, OUT):
    """int4 and int8 quantization of one bf16 leaf gives the same bytes on
    the card as on the CPU (true f32 divisions, round half to even), also
    at a dim that is no multiple of 128 (288: group size 96)."""
    from cold_compress_tpu_torch.quantization.weight_quant import (
        quantize_weight_int4, quantize_weight_int8,
    )
    from cold_compress_tpu_torch.runtime.engine import flatten_params

    w = (torch.randn((IN, OUT), device=dev, generator=_gen(dev, IN + OUT)) * 0.02)
    w = w.to(torch.bfloat16)
    for fn in (quantize_weight_int4, quantize_weight_int8):
        card, cpu = flatten_params(fn(w)), flatten_params(fn(w.cpu()))
        assert sorted(card) == sorted(cpu)
        for key in cpu:
            assert card[key].dtype == cpu[key].dtype, key
            assert card[key].tobytes() == cpu[key].tobytes(), key


@pytest.mark.parametrize("L", [1, 5, 32])
def test_w4a8_gemv_on_a_quantized_rowpack_leaf_matches_rowpack_plain(dev, L):
    """K10's path: a rowpack leaf from ``quantize_weight_int4`` (scales and
    zeros that vary per group), repacked once, through K1's kernel, against
    the rowpack function on the unrepacked bytes. Exact integer group dots:
    only the f32 order and the form of the zero term differ."""
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_weight_int4

    g = _gen(dev, 40 + L)
    leaf = quantize_weight_int4(torch.randn((1024, 384), device=dev, generator=g) * 0.02, 128)
    wg, sz = qmm.rowpack_to_gemv(leaf["w"], leaf["scales"], leaf["zeros"])
    x = torch.randn((L, 1024), device=dev, generator=g).to(torch.bfloat16)
    before = qmm.LAUNCHES["w4a8_gemv.w13"]
    y = qmm.w4a8_gemv(x, wg, sz, 128, counter="w4a8_gemv.w13")
    assert qmm.LAUNCHES["w4a8_gemv.w13"] == before + 1
    ref = qmm.w4a8_rowpack_plain(x, leaf["w"], leaf["scales"], leaf["zeros"], 128)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_int8_layer_projection_runs_w8a8_kernel(dev):
    """An int8 layer leaf (``quantize_weight_int8``) as the fused w13
    projection: K9 on the card, counted as ``w8a8_gemv.w13``, the same bits
    as the plain version on the CPU."""
    from cold_compress_tpu_torch.models.transformer import make_linear
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_weight_int8

    g = _gen(dev, 41)
    leaf = quantize_weight_int8(torch.randn((512, 768), device=dev, generator=g) * 0.05)
    x = torch.randn((1, 512), device=dev, generator=g).to(torch.bfloat16)
    card = make_linear(leaf, "w13")
    cpu = make_linear({k: v.cpu() if torch.is_tensor(v) else v for k, v in leaf.items()}, "w13")
    before = qmm.LAUNCHES["w8a8_gemv.w13"]
    y = card(x)
    assert qmm.LAUNCHES["w8a8_gemv.w13"] == before + 1
    assert torch.equal(y.cpu(), cpu(x.cpu()))


# ---------------------------------------------------------------------------
# Decode as a captured CUDA graph against the same step run eagerly
# ---------------------------------------------------------------------------

GRAPH_PROMPT = np.random.RandomState(0).randint(2, 500, size=300).tolist()
GRAPH_FORCED = np.random.RandomState(1).randint(2, 500, size=8).tolist()
#: (strategy, cache bits (16 = bf16), vocab head, extra cache options,
#: attn_top_k, decode attention's i8dot mode): the main path's kernels (kv8
#: heavy_hitter, i8dot by the TPU program's routing), hybrid's per-head
#: step, the counter-based draws of random, l2 over kv4 with the int8 head
#: (K9), the debug shadow and its loss counter, a full bf16 cache, the eager
#: W > 1 heavy-hitter history, attn_top_k < 1 (plain attention over the
#: dequantized cache), the position-only strategies, and the main path's
#: cache in the dequantizing branch and a kv4 one in the i8dot branch.
GRAPH_CASES = {
    "heavy_hitter_kv8": ("heavy_hitter", 8, "int4", {}, 1.0, "auto"),
    "hybrid_kv8": ("hybrid", 8, "int4", {}, 1.0, "auto"),
    "random_kv4": ("random", 4, "int4", {}, 1.0, "auto"),
    "l2_kv4_int8_head": ("l2", 4, "int8", {}, 1.0, "auto"),
    "debug_heavy_hitter_kv8": ("debug_heavy_hitter", 8, "int4", {}, 1.0, "auto"),
    "full_bf16": ("full", 16, "int4", {}, 1.0, "auto"),
    "heavy_hitter_kv8_window4": ("heavy_hitter", 8, "int4", {"history_window_size": 4}, 1.0,
                                 "auto"),
    "heavy_hitter_kv8_top_half": ("heavy_hitter", 8, "int4", {}, 0.5, "auto"),
    "keep_it_odd_kv2": ("keep_it_odd", 2, "int4", {}, 1.0, "auto"),
    "heavy_hitter_kv8_i8dot_off": ("heavy_hitter", 8, "int4", {}, 1.0, False),
    "heavy_hitter_kv4_i8dot_on": ("heavy_hitter", 4, "int4", {}, 1.0, True),
}


@pytest.fixture(scope="module")
def graph_models():
    """TestKernel with random int4 layers and an int4 or int8 head, on the
    card (built once: the tests' caches come and go, the weights stay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
    from cold_compress_tpu_torch.runtime.engine import build_model, params_from_flat

    cfg = ModelConfig.from_name("TestKernel")
    return cfg, {head: build_model(cfg, params_from_flat(random_quantized_params(
        cfg, seed=0, head_mode=head), "cuda"), "cuda", max_positions=512)
        for head in ("int4", "int8")}


def _graph_caches(cfg, case):
    from cold_compress_tpu_torch.bench import cache_kwargs
    from cold_compress_tpu_torch.models.transformer import init_caches
    from cold_compress_tpu_torch.runtime.engine import build_cache_specs

    strategy, bits, _, extra, _, _ = case
    kw = cache_kwargs(strategy, 0.25, 4, None if bits == 16 else bits) | extra
    return init_caches(cfg, build_cache_specs(cfg, kw, 512), 1, torch.bfloat16, device="cuda")


def _decode_run(model, caches, graph, top_k, **kw):
    """(sequence, emitted probabilities, final probabilities, every cache
    tensor on the host, kernel launches, the graph's record) of one
    ``generate()``."""
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.runtime.generate import generate

    reset_kernel_launches()
    seq, info, caches = generate(model, caches, GRAPH_PROMPT, 8, prefill_bucket=512,
                                 attn_top_k=top_k, cuda_graph=graph, **kw)
    launches = {k: n for k, n in kernel_launches().items() if n}
    tensors = [t.cpu() for c in caches for t in c.tensors()]
    return (seq, np.asarray(info["emitted_probs"]), np.asarray(info["final_probs"]), tensors,
            launches, info["decode_graph"], info["perf_stats"]["decode_steps"])


def _assert_same_run(a, b):
    seq, e, f, tensors, launches = a[:5]
    assert seq == b[0]
    assert np.array_equal(e, b[1]) and np.array_equal(f, b[2])
    assert len(tensors) == len(b[3])
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(tensors, b[3]))
    assert launches == b[4] and a[6] == b[6]


@pytest.mark.parametrize("mode", ["teacher_forced", "terminator"])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_decode_is_bit_equal_to_eager(graph_models, case, mode):
    """The same ``generate()`` decoded through the captured step and
    eagerly (``cuda_graph=False``): the same tokens, emitted and final
    probabilities, every tensor of every cache state (``extra`` and the
    debug shadow included) and kernel launches, bit for bit. Teacher-forced,
    or greedy with the third token a terminator (the loop stops after the
    step that emits it). A second call on the same caches after
    ``reset_caches`` replays without capturing again and equals a fresh
    eager run."""
    from cold_compress_tpu_torch.models.transformer import set_attn_i8dot
    from cold_compress_tpu_torch.runtime.generate import reset_caches

    cfg, models = graph_models
    spec = GRAPH_CASES[case]
    model, top_k = models[spec[2]], spec[4]
    set_attn_i8dot(model, spec[5])
    try:
        _graph_against_eager(cfg, model, spec, top_k, mode, reset_caches)
    finally:
        set_attn_i8dot(model, "auto")


def _graph_against_eager(cfg, model, spec, top_k, mode, reset_caches):
    if mode == "teacher_forced":
        kw = {"next_tokens": GRAPH_FORCED}
    else:
        # The generated token first emitted latest (by step 1 or later, so
        # that at least one step replays) becomes the terminator.
        gen = _decode_run(model, _graph_caches(cfg, spec), False, top_k)[0][len(GRAPH_PROMPT):]
        stop = max(gen[1:], key=gen.index)
        assert gen.index(stop) >= 2, gen
        kw = {"terminator_ids": [stop]}
    eager = _decode_run(model, _graph_caches(cfg, spec), False, top_k, **kw)
    assert eager[5] is None
    caches = _graph_caches(cfg, spec)
    first = _decode_run(model, caches, True, top_k, **kw)
    assert first[5]["captured"] and first[5]["launches_per_replay"]
    _assert_same_run(first, eager)
    second = _decode_run(model, reset_caches(caches), True, top_k, **kw)
    assert not second[5]["captured"], "the second call captured again"
    _assert_same_run(second, eager)
    if mode == "terminator":
        assert eager[6] == gen.index(stop), "the loop did not stop at the terminator"


def test_graph_recaptures_when_the_i8dot_mode_changes(graph_models):
    """A step captured with decode attention in one branch is never replayed
    in the other: after a switch of ``set_attn_i8dot`` the next call
    captures again, launches the other branch's kernel and equals an eager
    run in that mode; switching back captures again."""
    from cold_compress_tpu_torch.models.transformer import set_attn_i8dot
    from cold_compress_tpu_torch.runtime.generate import reset_caches

    cfg, models = graph_models
    model, spec = models["int4"], GRAPH_CASES["heavy_hitter_kv8"]
    kw = {"next_tokens": GRAPH_FORCED}
    caches = _graph_caches(cfg, spec)
    try:
        runs = {}
        for mode in ("auto", False, "auto"):
            set_attn_i8dot(model, mode)
            eager = _decode_run(model, _graph_caches(cfg, spec), False, 1.0, **kw)
            graph = _decode_run(model, reset_caches(caches), True, 1.0, **kw)
            assert graph[5]["captured"], mode
            _assert_same_run(graph, eager)
            counter = "decode_attention.kv8" + (".i8dot" if mode == "auto" else "")
            assert graph[4].get(counter) == cfg.n_layer * 7, (mode, graph[4])
            runs[mode] = graph
        assert not np.array_equal(runs["auto"][1], runs[False][1])
    finally:
        set_attn_i8dot(model, "auto")


def _gptq_calibration(IN, OUT, seed=0):
    """Correlated activations and W, as tests/test_torch_gptq.py draws them."""
    rng = np.random.RandomState(seed)
    basis = rng.standard_normal((16, IN))
    x = (rng.standard_normal((4 * IN, 16)) @ basis
         + 0.1 * rng.standard_normal((4 * IN, IN))).astype(np.float32)
    W = (rng.standard_normal((IN, OUT)) * 0.05).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(W)


@pytest.mark.parametrize("IN,OUT,gs", [(256, 768, 64), (768, 256, 64), (1024, 512, 128),
                                       (200, 96, 64)])
def test_gptq_blocked_on_card_within_bound_of_cpu_contract(dev, IN, OUT, gs):
    """GPTQ's blocked form on the card (a group's row loop replayed as a
    CUDA graph) against the row-by-row contract on the CPU, on one W and
    H, within the bounds ``chip_smoke.py`` holds the 8B run to."""
    from chip_smoke import GPTQ_BLOCKED_BOUNDS, blocked_differences
    from cold_compress_tpu_torch.quantization.gptq import _hessian, gptq_quantize_matrix

    x, W = _gptq_calibration(IN, OUT)
    H = _hessian(x)
    rows = gptq_quantize_matrix(W, H, gs)
    card = gptq_quantize_matrix(W.to(dev), H.to(dev), gs, blocked=True)
    assert card["w"].device.type == "cuda"
    diff = blocked_differences(rows, card, x.to(dev), W.to(dev))
    assert all(diff[k] <= GPTQ_BLOCKED_BOUNDS[k] for k in diff), diff


def test_gptq_params_on_card_launch_flash_prefill_per_layer(dev):
    """``gptq_quantize_params`` on TestKernel on the card: its calibration
    attention (head_dim 128, P = 512) is K4, once per layer; the int4 tree
    runs."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_params, make_rope_table
    from cold_compress_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from cold_compress_tpu_torch.quantization.gptq import gptq_quantize_params
    from cold_compress_tpu_torch.runtime.engine import build_model

    cfg = ModelConfig.from_name("TestKernel")
    params = init_params(cfg, _gen(dev, 0), torch.bfloat16, dev)
    reset_kernel_launches()
    tree = gptq_quantize_params(cfg, params, make_rope_table(cfg, 512, device=dev),
                                n_samples=2, seq_length=512, verbose=False)
    assert {k: v for k, v in kernel_launches().items() if v} == {
        "flash_prefill_summary": cfg.n_layer}
    assert tree["output"]["w"].device.type == "cuda"
    model = build_model(cfg, tree, dev, max_positions=512)
    with torch.inference_mode():
        logits = model.output(model.tok_embeddings[None, :4])  # the int4 head, K2
    assert bool(torch.isfinite(logits.float()).all())


def test_tp2_generate_matches_the_single_card(dev):
    """``generate`` at tp = 2 on TestKernel widened (four query heads over
    two KV heads, head_dim 128), int4 layers and head, a kv8 heavy-hitter
    cache, teacher-forced: NCCL with one card per rank where two are
    visible (decode through the captured graph), else two gloo ranks
    sharing the card (eager decode); probabilities within 5e-2 of the
    single-card run's largest (row-parallel W4A8 quantizes activations per
    local input segment; on the CPU the same comparison is 2.2% apart)."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_caches, init_params
    from cold_compress_tpu_torch.parallel.launch import launch
    from cold_compress_tpu_torch.parallel.tp_decode import rank_generate
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_params
    from cold_compress_tpu_torch.runtime.engine import (
        build_cache_specs, build_model, flatten_params, params_from_flat,
    )
    from cold_compress_tpu_torch.runtime.generate import generate

    cfg = ModelConfig.from_name("TestKernel").replace(dim=512, n_head=4, n_kv_head=2)
    flat = flatten_params(quantize_params(init_params(cfg, device="cpu"), "int4", 128,
                                          output_mode="int4"))
    kw = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25], "cache_bits": 8,
          "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
          "recent_window": 10}
    prompt = np.random.RandomState(2).randint(2, 500, size=200).tolist()
    forced = np.random.RandomState(3).randint(2, 500, size=8).tolist()
    model = build_model(cfg, params_from_flat(flat, dev), dev, max_positions=512)
    caches = init_caches(cfg, build_cache_specs(cfg, kw, 512), 1, torch.bfloat16, device=dev)
    _, ref, _ = generate(model, caches, prompt, 8, next_tokens=forced, prefill_bucket=512)
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    run = functools.partial(rank_generate, max_seq_length=512, build_kw={"max_positions": 512},
                            next_tokens=forced, prefill_bucket=512)
    out = launch(run, cfg, flat, kw, prompt, 8, tp=2, device="cuda", backend=backend)
    for seq, info in out:
        assert seq == prompt + forced
        assert (info["decode_graph"] is not None) == (backend == "nccl")
        for key in ("emitted_probs", "final_probs"):
            got, want = np.asarray(info[key]), np.asarray(ref[key])
            gap, tol = np.abs(got - want).max(), 5e-2 * np.abs(want).max()
            print(f"tp=2 {key} against the single card: {gap:.3e} (bound {tol:.3e})")
            assert gap <= tol, key


@pytest.mark.parametrize("Pq,q_offset,Pk,plen", [
    (4096, 0, 8192, 7928), (4096, 4096, 8192, 7928), (2048, 6144, 8192, 7928),
    (64, 8128, 8192, 7928), (64, 4096, 4160, 7928), (64, 0, 64, 500), (64, 448, 512, 500),
    (64, 128, 256, 236), (128, 64, 512, 492)])
def test_flash_prefill_partial_matches_plain(dev, Pq, q_offset, Pk, plen):
    """K4 over a query block at an offset (the sequence-parallel shards and
    the pipeline chunks of ``chip_smoke.py`` phase 2, pipeline chunks whose
    keys end before the prompt does, and blocks short of the keys' end)
    against its plain version; zeros past the block's last row; K/V given
    as a row slice of a longer buffer read in place."""
    g = _gen(dev, Pq + q_offset)
    q = torch.randn((1, 32, Pq, 128), device=dev, generator=g).to(torch.bfloat16)
    kbuf = torch.randn((1, 8, Pk + 128, 128), device=dev, generator=g).to(torch.bfloat16)
    vbuf = torch.randn((1, 8, Pk + 128, 128), device=dev, generator=g).to(torch.bfloat16)
    k, v = kbuf[:, :, :Pk], vbuf[:, :, :Pk]
    y, cum, obs = prefill_attn.flash_prefill_partial(q, k, v, plen, q_offset=q_offset)
    ry, rcum, robs = prefill_attn.chunked_prefill_partial(q, k, v, plen, q_offset=q_offset,
                                                          need_summary=True)
    _assert_bf16_out_close(y, ry, 2**-7)
    for got, ref in ((cum, rcum), (obs, robs)):
        tol = 1e-4 * float(ref.abs().max()) + 1e-7
        torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    assert not bool(cum[..., q_offset + Pq:].any())
    y2, _, _ = prefill_attn.flash_prefill_partial(q, k.contiguous(), v.contiguous(), plen,
                                                  q_offset=q_offset)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("windows", [(2457,), (819, 2457)])
def test_flash_profile_partial_matches_plain(dev, windows):
    """K6 over sp = 2's second query block of the 8B hybrid run."""
    g = _gen(dev, len(windows))
    q = torch.randn((1, 32, 4096, 128), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((1, 8, 8192, 128), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((1, 8, 8192, 128), device=dev, generator=g).to(torch.bfloat16)
    y, cum, wcols = prefill_attn.flash_profile_partial(q, k, v, 7928, windows, q_offset=4096)
    ry, _, _ = prefill_attn.chunked_prefill_partial(q, k, v, 7928, q_offset=4096)
    rcum, rw = prefill_attn.profile_partial(q, k, 7928, windows, q_offset=4096)
    _assert_bf16_out_close(y, ry, 2**-7)
    for got, ref in ((cum, rcum), (wcols, rw)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_partial_at_offset_zero_is_bit_equal_to_k4_and_k6(dev):
    """At ``q_offset = 0`` with as many rows as keys the query-block forms
    return exactly K4's y and the raw sums behind its summary, and K6's y,
    cum and window sums."""
    from cold_compress_tpu_torch.ops.attention import finalize_summary

    g = _gen(dev, 17)
    q = torch.randn((1, 32, 2048, 128), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((1, 8, 2048, 128), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((1, 8, 2048, 128), device=dev, generator=g).to(torch.bfloat16)
    y, cum, obs = prefill_attn.flash_prefill_partial(q, k, v, 2000)
    y0, s0 = prefill_attn.flash_prefill(q, k, v, 2000)
    s = finalize_summary(cum, obs, torch.full((1,), 2000, dtype=torch.int32, device=dev), 2048,
                         16)
    assert torch.equal(y, y0) and all(torch.equal(s[key], s0[key]) for key in s0)
    got = prefill_attn.flash_profile_partial(q, k, v, 2000, (100, 600))
    want = prefill_attn.flash_profile(q, k, v, 2000, (100, 600))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("layout", [{"sp": 2}, {"pp": 2}])
def test_sp2_and_pp2_generate_match_the_single_card(dev, layout):
    """``generate`` at sp = 2 and pp = 2 on TestKernel widened, int4
    layers and head, a kv8 heavy-hitter cache over a 500-token prompt
    (bucket 512: shards of 256 rows, chunks of 64), teacher-forced: every
    rank's probabilities within 2e-2 of the single card's largest (the
    chunks' and shards' bf16 matmuls round apart from the whole prompt's,
    and a random TestKernel's greedy tokens part at near-ties). NCCL with
    one card per rank where two are visible, else two gloo ranks sharing
    the card."""
    from cold_compress_tpu_torch.models.config import ModelConfig
    from cold_compress_tpu_torch.models.transformer import init_caches, init_params
    from cold_compress_tpu_torch.parallel.launch import launch
    from cold_compress_tpu_torch.parallel.tp_decode import rank_generate
    from cold_compress_tpu_torch.quantization.weight_quant import quantize_params
    from cold_compress_tpu_torch.runtime.engine import (
        build_cache_specs, build_model, flatten_params, params_from_flat,
    )
    from cold_compress_tpu_torch.runtime.generate import generate

    cfg = ModelConfig.from_name("TestKernel").replace(dim=512, n_head=4, n_kv_head=2)
    flat = flatten_params(quantize_params(init_params(cfg, device="cpu"), "int4", 128,
                                          output_mode="int4"))
    kw = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [0.25], "cache_bits": 8,
          "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
          "recent_window": 10}
    prompt = np.random.RandomState(4).randint(2, 500, size=500).tolist()
    forced = np.random.RandomState(5).randint(2, 500, size=8).tolist()
    model = build_model(cfg, params_from_flat(flat, dev), dev, max_positions=512)
    caches = init_caches(cfg, build_cache_specs(cfg, kw, 512), 1, torch.bfloat16, device=dev)
    _, ref, _ = generate(model, caches, prompt, 8, next_tokens=forced)
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    run = functools.partial(rank_generate, max_seq_length=512, build_kw={"max_positions": 512},
                            next_tokens=forced)
    for seq, info in launch(run, cfg, flat, kw, prompt, 8, device="cuda", backend=backend,
                            **layout):
        assert seq == prompt + forced
        for key in ("emitted_probs", "final_probs"):
            got, want = np.asarray(info[key]), np.asarray(ref[key])
            gap, tol = np.abs(got - want).max(), 2e-2 * np.abs(want).max()
            print(f"{layout} {key} against the single card: {gap:.3e} (bound {tol:.3e})")
            assert gap <= tol, key
