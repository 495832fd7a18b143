"""Decode attention over the KV cache at every precision (kernels K3 and
K5): wrapper and plain version.

Counterpart of ``cold_compress_tpu/ops/pallas_decode_attn.py``. The CUDA
kernel (``csrc/decode_attn.cu``) replaces ``quantized_decode_attention``
(pallas_decode_attn.py:899): its one-shot ``_kernel`` (K3) at bits 16/8/4/2
with and without pooled probabilities, and its chunked, manual and v2
variants (K5), which serve caches above the TPU's one-shot budget. One
split-C kernel serves every cache length and follows the one-shot numerics
at all of them (the ``i8dot=False`` branch): K and V are dequantized
(``u * s + (z - 2^(bits-1) s)``, rounded to bf16; a bf16 cache is read as
it is), scores and softmax are f32, the probabilities are cast to bf16
before P.V, and, when asked for, the probabilities averaged over the G
query heads are returned for the heavy-hitter history. The TPU's chunked
kernel rounds the unnormalised ``e`` instead (pallas_decode_attn.py:330),
which moves ``out`` by up to about two bf16 units (tests bound it). The
TPU's ``i8dot`` (int8 query and probabilities on the MXU) is a TPU-specific
trick and stays a later option.

Bound on the H100: bytes (K and V of every KV head, 2*C*D*bits/8 bytes
each, plus the per-slot scale/zero/mask). Design: one launch per call. Each
(batch, KV head) is a thread-block cluster of up to 16 CTAs that split C
into contiguous ranges (``cluster_size``, ``cta_ranges``); each CTA streams
its rows through a three-stage ``cp.async`` ring of padded rows, takes
scores and P.V on the tensor cores, keeps its scores in shared memory
(``scores_in_smem``; else a global workspace, still in the same launch),
and the cluster folds its softmax statistics and its partial outputs
through distributed shared memory in CTA order, so every sum has a fixed
order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30

HEAD_DIM = 128
MAX_GROUP = 8
BITS = (16, 8, 4, 2)


def variant(bits: int, need_attn: bool) -> str:
    """Launch-counter name of one (bits, need_attn) variant."""
    fmt = "bf16" if bits == 16 else f"kv{bits}"
    return f"decode_attention.{fmt}" + ("" if need_attn else ".noattn")


#: Launch count of the CUDA kernel per variant (incremented only where it
#: launches).
LAUNCHES = {variant(b, a): 0 for b in BITS for a in (True, False)}


#: CTAs of one cluster: at most 16 (above the portable 8, where the card
#: fits them), one per 128 cache slots.
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
SLOTS_PER_CTA = 128
#: A CTA's scores (G * slots * 4 bytes) above this go to a global workspace.
SMEM_SCORE_BYTES = 64 * 1024


def cluster_size(C: int, cap: int = MAX_CLUSTER) -> int:
    """CTAs per cluster for a cache of C slots: ceil(C / 128), at most
    ``cap``."""
    return max(1, min(cap, -(-C // SLOTS_PER_CTA)))


def cta_ranges(C: int, nc: int):
    """The contiguous slot range [begin, end) of each CTA of an ``nc``-CTA
    cluster, as the kernel cuts it: ceil(C / nc) slots each, the last one
    ragged."""
    per = -(-C // nc)
    return [(min(C, i * per), min(C, (i + 1) * per)) for i in range(nc)]


def scores_in_smem(C: int, G: int, nc: int) -> bool:
    """Whether each CTA keeps its G heads' scores in shared memory."""
    return G * -(-C // nc) * 4 <= SMEM_SCORE_BYTES


def decode_attn_supported(q_shape, n_kv_head: int) -> bool:
    """Shapes the kernel takes: one query token, head_dim 128, G <= 8."""
    B, H, L, D = q_shape
    return L == 1 and D == HEAD_DIM and H // n_kv_head <= MAX_GROUP


def packed_width(bits: int, head_dim: int = HEAD_DIM) -> int:
    """Last-axis width of one cached row: D values (bf16, int8) or D*bits/8
    packed bytes."""
    return head_dim if bits in (16, 8) else head_dim * bits // 8


def dequantize_bf16(u: torch.Tensor, scales, zeros, bits: int) -> torch.Tensor:
    """Cached rows as the kernel reads them: f32 values rounded to bf16.

    bits 4/2 unpack the segment packing (byte j, bit range s holds column
    j + s*D/per); the affine map is a separate f32 multiply and add,
    ``u * s + (z - 2^(bits-1) * s)``."""
    if bits == 16:
        return u.to(torch.bfloat16).float()
    per = 8 // bits
    if per > 1:
        p = u.to(torch.int32)
        m = (1 << bits) - 1
        u = torch.cat([(p >> (bits * s)) & m for s in range(per)], dim=-1)
    zp = zeros - float(2 ** (bits - 1)) * scales
    x = u.float() * scales[..., None] + zp[..., None]
    return x.to(torch.bfloat16).float()


def decode_attention_plain(q, k, v, k_scales, k_zeros, v_scales, v_zeros, mask,
                           bits: int, need_attn: bool
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: returns (out [B, H, 1, D] in q's dtype,
    pooled [B, KVH, 1, C] f32 or None)."""
    B, H, _, D = q.shape
    KVH, C = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qb = q.reshape(B, KVH, G, D).to(torch.bfloat16).float()
    kf = dequantize_bf16(k, k_scales, k_zeros, bits)
    vf = dequantize_bf16(v, v_scales, v_zeros, bits)
    s = torch.einsum("bkgd,bkcd->bkgc", qb, kf) * scale
    s = s.masked_fill(~mask[:, :, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgc,bkcd->bkgd", probs.to(torch.bfloat16).float(), vf)
    out = o.reshape(B, H, 1, D).to(q.dtype)
    if not need_attn:
        return out, None
    pooled = probs.sum(dim=2) * (1.0 / G)
    return out, pooled[:, :, None, :]


def _lib():
    lib = _build.library("decode_attn")
    fn, ws = lib.decode_attention, lib.decode_attention_workspace
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_size_t
        fits = lib.decode_attention_max_clusters
        fits.argtypes = [ctypes.c_int] * 7
        fits.restype = ctypes.c_int
    return fn, ws


#: cudaOccupancyMaxActiveClusters per (B, KVH, C, G, nc, bits, need_attn).
_MAX_CLUSTERS = {}


def max_active_clusters(B, KVH, C, G, nc, bits, need_attn) -> int:
    """Clusters of ``nc`` CTAs of this variant that the card holds at once."""
    key = (B, KVH, C, G, nc, bits, bool(need_attn))
    if key not in _MAX_CLUSTERS:
        _lib()
        n = _build.library("decode_attn").decode_attention_max_clusters(*key[:6], int(need_attn))
        _build.check(max(0, -n), "decode_attention_max_clusters")
        _MAX_CLUSTERS[key] = n
    return _MAX_CLUSTERS[key]


def default_cluster(B, KVH, C, G, bits, need_attn) -> int:
    """CTAs per cluster the wrapper takes: ``cluster_size(C)``, or above 8
    the largest size whose B * KVH clusters all fit on the card at once
    (16-CTA clusters need a GPC of 16 free SMs, which not every GPC has),
    else 8."""
    nc = cluster_size(C)
    while nc > PORTABLE_CLUSTER and max_active_clusters(B, KVH, C, G, nc, bits,
                                                        need_attn) < B * KVH:
        nc -= 1
    return nc


def decode_attention(q, k, v, k_scales, k_zeros, v_scales, v_zeros, mask, *,
                     bits: int, need_attn: bool, cluster: Optional[int] = None):
    """Returns (out [B, H, 1, D], pooled attn [B, KVH, 1, C] or None), the
    contract of gqa_attention's decode path. ``bits`` is the cache's
    precision (16 for a bf16 cache, whose scale/zero arguments are None).
    ``cluster`` fixes the CTAs per cluster (1..16, at most C); by default
    ``default_cluster``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, k_scales, k_zeros, v_scales, v_zeros, mask, bits, need_attn
        )
    name = "decode_attention"
    B, H, L, D = q.shape
    KVH, C = k.shape[1], k.shape[2]
    if bits not in BITS:
        raise ValueError(f"{name}: cache bits {bits} (takes {BITS})")
    if L != 1 or D != HEAD_DIM or H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"{name}: unsupported q {tuple(q.shape)} for {KVH} KV heads")
    G = H // KVH
    row = (B, KVH, C, packed_width(bits))
    checks = [("mask", mask, torch.bool, (B, KVH, C))]
    if bits == 16:
        checks += [("k", k, torch.bfloat16, row), ("v", v, torch.bfloat16, row)]
    else:
        checks += [("k", k, torch.uint8, row), ("v", v, torch.uint8, row)] + [
            (n, t, torch.float32, (B, KVH, C))
            for n, t in (("k_scales", k_scales), ("k_zeros", k_zeros),
                         ("v_scales", v_scales), ("v_zeros", v_zeros))
        ]
    for n, t, dt, shape in checks:
        if t is None or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype)
            raise ValueError(f"{name}: bad {n} {got}, want {shape} {dt}")
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on another device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: cache rows must be 16-byte aligned")
    if cluster is None:
        nc = default_cluster(B, KVH, C, G, bits, need_attn)
    elif not 1 <= cluster <= min(MAX_CLUSTER, C):
        raise ValueError(f"{name}: cluster {cluster} (takes 1..{min(MAX_CLUSTER, C)})")
    else:
        nc = cluster
    qb = q.to(torch.bfloat16).contiguous()  # the TPU kernel casts q too
    launch, workspace_floats = _lib()
    # The kernel writes bf16 itself; another query dtype gets f32 and a cast.
    out_bf16 = q.dtype == torch.bfloat16
    out = torch.empty((B, H, 1, D), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                      device=q.device)
    pooled = (torch.empty((B, KVH, 1, C), dtype=torch.float32, device=q.device)
              if need_attn else None)
    # Scores that do not fit in the CTAs' shared memory (none at C <= 32768
    # for G <= 4).
    n_ws = workspace_floats(B, KVH, C, G, nc)
    workspace = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = launch(
        qb.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scales), ptr(k_zeros),
        ptr(v_scales), ptr(v_zeros), mask.data_ptr(), out.data_ptr(), ptr(pooled),
        ptr(workspace), B, KVH, C, G, nc, bits, int(need_attn), int(out_bf16),
        1.0 / math.sqrt(D), _build.stream_ptr(q.device),
    )
    _build.check(status, name)
    LAUNCHES[variant(bits, need_attn)] += 1
    return (out if out_bf16 else out.to(q.dtype)), pooled
