"""Decode attention over the KV cache at every precision (kernels K3 and
K5): wrapper and plain versions.

Counterpart of ``cold_compress_tpu/ops/pallas_decode_attn.py``. The CUDA
kernel (``csrc/decode_attn.cu``) replaces ``quantized_decode_attention``
(pallas_decode_attn.py:899): its one-shot ``_kernel`` (K3) at bits 16/8/4/2
with and without pooled probabilities, and its chunked, manual and v2
variants (K5), which serve caches above the TPU's one-shot budget. One
split-C kernel serves every cache length and follows the one-shot numerics
at all of them, in either of the TPU kernel's two branches:

- ``i8dot=False`` (``decode_attention_plain``): K and V are dequantized
  (``u * s + (z - 2^(bits-1) s)``, rounded to bf16; a bf16 cache is read as
  it is), scores and softmax are f32, the probabilities are cast to bf16
  before P.V. The TPU's chunked kernel rounds the unnormalised ``e``
  instead (pallas_decode_attn.py:330), which moves ``out`` by up to about
  two bf16 units (tests bound it).
- ``i8dot=True`` (``decode_attention_i8dot_plain``; ``_i8_scores`` and
  ``_i8_pv``, pallas_decode_attn.py:118-162), for bits 8/4/2: q quantized
  per row to int8, scores as int32 dots with the cached integers plus
  rank-1 f32 fix-ups, ``p * s_v`` quantized per row to int8 for an int32
  P.V plus ``sum_c p * z``. The TPU's chunked kernel quantizes each chunk's
  unnormalised ``e`` with its own scale (pallas_decode_attn.py:274-296);
  the port quantizes the normalised p over all C (tests bound the gap).

Either way, when asked for, the probabilities averaged over the G query
heads are returned for the heavy-hitter history. ``i8dot_route`` picks the
branch as the TPU program does by default: ``i8dot`` for an int8 cache
where the TPU would run its kernel, the dequantizing branch elsewhere.

Bound on the H100: bytes (K and V of every KV head, 2*C*D*bits/8 bytes
each, plus the per-slot scale/zero/mask). Design: one launch per call. Each
(batch, KV head) is a thread-block cluster of up to 16 CTAs that split C
into contiguous ranges (``cluster_size``, ``cta_ranges``); each CTA streams
its rows through a three-stage ``cp.async`` ring of padded rows, takes
scores and P.V on the tensor cores (bf16 ``mma.sync``, or s8 with s32 sums
for ``i8dot``), keeps its scores in shared memory (``scores_in_smem``; else
a global workspace, still in the same launch), and the cluster folds its
softmax statistics and its partial outputs through distributed shared
memory in CTA order, so every sum has a fixed order.
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


I8DOT_BITS = (8, 4, 2)


def variant(bits: int, need_attn: bool, i8dot: bool = False) -> str:
    """Launch-counter name of one (bits, need_attn, i8dot) variant."""
    fmt = "bf16" if bits == 16 else f"kv{bits}"
    return (f"decode_attention.{fmt}" + (".i8dot" if i8dot else "")
            + ("" if need_attn else ".noattn"))


#: Launch count of the CUDA kernel per variant (incremented only where it
#: launches).
LAUNCHES = {variant(b, a): 0 for b in BITS for a in (True, False)}
LAUNCHES.update({variant(b, a, True): 0 for b in I8DOT_BITS for a in (True, False)})

#: The JAX program's routing constants at their defaults
#: (pallas_decode_attn.py: ``CCT_ATTN_OS_BUDGET_MB`` 40, ``_VMEM_KV_BUDGET``,
#: ``_DECODE_CHUNK``).
TPU_ONESHOT_BUDGET = 40 * 2**20
TPU_CHUNK_BUDGET = 10 * 2**20
TPU_DECODE_CHUNK = 512


def tpu_runs_kernel(bits: int, C: int, n_kv_head: int, head_dim: int = HEAD_DIM) -> bool:
    """Whether the JAX program on a TPU sends a one-token decode step over a
    cache of C slots to its Pallas kernel: a copy of ``decode_attn_supported``
    (pallas_decode_attn.py:1082-1134) at its default settings. Elsewhere it
    takes the XLA einsum over the dequantized cache."""
    if bits not in BITS or C % 128 or head_dim % 128:
        return False
    row = head_dim * 2 if bits == 16 else head_dim * bits // 8
    kv_full = 2 * n_kv_head * C * row
    if bits == 16 and kv_full > TPU_ONESHOT_BUDGET:
        return False
    if C % TPU_DECODE_CHUNK == 0 and C >= 2 * TPU_DECODE_CHUNK:
        return (kv_full <= TPU_ONESHOT_BUDGET
                or 2 * n_kv_head * TPU_DECODE_CHUNK * row <= TPU_CHUNK_BUDGET)
    return kv_full <= max(TPU_ONESHOT_BUDGET, TPU_CHUNK_BUDGET)


#: ``i8dot`` modes: ``"auto"`` (the TPU program's default), True, False.
I8DOT_MODES = ("auto", True, False)


def i8dot_route(mode, bits: int, C: int, n_kv_head: int, head_dim: int = HEAD_DIM) -> bool:
    """The ``i8dot`` argument for one call. ``"auto"`` copies the TPU
    program's default (``CCT_ATTN_I8DOT`` unset, pallas_decode_attn.py:930-942):
    on for an int8 cache where the TPU runs its kernel (``tpu_runs_kernel``),
    off elsewhere (where it takes the dequantizing XLA einsum, for kv4/kv2 and
    for bf16). True asks for it at any quantized cache and raises at bf16."""
    if mode == "auto":
        return bits == 8 and tpu_runs_kernel(bits, C, n_kv_head, head_dim)
    if mode is True:
        if bits not in I8DOT_BITS:
            raise ValueError(f"i8dot needs a quantized cache (bits {I8DOT_BITS}), not {bits}")
        return True
    if mode is False:
        return False
    raise ValueError(f"i8dot mode {mode!r} (takes {I8DOT_MODES})")


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


def int_values(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Cached rows [..., D * bits / 8] uint8 as the integers the i8dot branch
    multiplies, int32 [..., D] in column order: kv8 ``u ^ 0x80`` read as int8
    (u - 128, paired with the raw zeros); kv4/kv2 the unsigned values of each
    bit range (segment s is columns [s*D/per, (s+1)*D/per), the TPU's
    ``_int_segs``, paired with the folded zeros)."""
    p = u.to(torch.int32)
    if bits == 8:
        return p - 128
    m = (1 << bits) - 1
    return torch.cat([(p >> (bits * s)) & m for s in range(8 // bits)], dim=-1)


def dequantize_bf16(u: torch.Tensor, scales, zeros, bits: int) -> torch.Tensor:
    """Cached rows as the kernel reads them: f32 values rounded to bf16.

    bits 4/2 unpack the segment packing (byte j, bit range s holds column
    j + s*D/per); the affine map is a separate f32 multiply and add,
    ``u * s + (z - 2^(bits-1) * s)``."""
    if bits == 16:
        return u.to(torch.bfloat16).float()
    if bits < 8:
        u = int_values(u, bits)
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


def decode_attention_i8dot_plain(q, k, v, k_scales, k_zeros, v_scales, v_zeros, mask,
                                 bits: int, need_attn: bool
                                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the ``i8dot`` branch (bits 8/4/2), operation
    by operation as ``_i8_scores``/``_i8_pv`` (pallas_decode_attn.py:118-199)
    with one ``ps`` over all C: returns (out [B, H, 1, D] in q's dtype, pooled
    [B, KVH, 1, C] f32 or None). The integer dots are exact in f32 (q.k:
    |sum| < 2^24) and f64 (p.v), so their order does not matter."""
    B, H, _, D = q.shape
    KVH, C = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    off = float(2 ** (bits - 1))
    k_off = k_zeros if bits == 8 else k_zeros - off * k_scales
    v_off = v_zeros if bits == 8 else v_zeros - off * v_scales
    qf = q.reshape(B, KVH, G, D).to(torch.bfloat16).float()
    qs = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    qq = torch.round(qf / qs)
    qsum = qf.sum(dim=-1, keepdim=True)
    di = torch.einsum("bkgd,bkcd->bkgc", qq, int_values(k, bits).float())
    s = (di * qs * k_scales[:, :, None, :] + qsum * k_off[:, :, None, :]) * scale
    s = s.masked_fill(~mask[:, :, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    ep = probs * v_scales[:, :, None, :]
    ps = ep.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) * (1.0 / 127.0)
    pq = torch.round(ep / ps)
    dv = torch.einsum("bkgc,bkcd->bkgd", pq.double(), int_values(v, bits).double()).float()
    zterm = (probs * v_off[:, :, None, :]).sum(dim=-1, keepdim=True)
    out = (dv * ps + zterm).reshape(B, H, 1, D).to(q.dtype)
    if not need_attn:
        return out, None
    pooled = probs.sum(dim=2) * (1.0 / G)
    return out, pooled[:, :, None, :]


def _lib():
    lib = _build.library("decode_attn")
    fn, ws = lib.decode_attention, lib.decode_attention_workspace
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_size_t
        fits = lib.decode_attention_max_clusters
        fits.argtypes = [ctypes.c_int] * 8
        fits.restype = ctypes.c_int
    return fn, ws


#: cudaOccupancyMaxActiveClusters per (B, KVH, C, G, nc, bits, need_attn, i8dot).
_MAX_CLUSTERS = {}


def max_active_clusters(B, KVH, C, G, nc, bits, need_attn, i8dot=False) -> int:
    """Clusters of ``nc`` CTAs of this variant that the card holds at once."""
    key = (B, KVH, C, G, nc, bits, bool(need_attn), bool(i8dot))
    if key not in _MAX_CLUSTERS:
        _lib()
        n = _build.library("decode_attn").decode_attention_max_clusters(
            *key[:6], int(need_attn), int(i8dot))
        _build.check(max(0, -n), "decode_attention_max_clusters")
        _MAX_CLUSTERS[key] = n
    return _MAX_CLUSTERS[key]


def default_cluster(B, KVH, C, G, bits, need_attn, i8dot=False) -> int:
    """CTAs per cluster the wrapper takes: ``cluster_size(C)``, or above 8
    the largest size whose B * KVH clusters all fit on the card at once
    (16-CTA clusters need a GPC of 16 free SMs, which not every GPC has),
    else 8."""
    nc = cluster_size(C)
    while nc > PORTABLE_CLUSTER and max_active_clusters(B, KVH, C, G, nc, bits,
                                                        need_attn, i8dot) < B * KVH:
        nc -= 1
    return nc


def decode_attention(q, k, v, k_scales, k_zeros, v_scales, v_zeros, mask, *,
                     bits: int, need_attn: bool, i8dot: bool = False,
                     cluster: Optional[int] = None):
    """Returns (out [B, H, 1, D], pooled attn [B, KVH, 1, C] or None), the
    contract of gqa_attention's decode path. ``bits`` is the cache's
    precision (16 for a bf16 cache, whose scale/zero arguments are None).
    ``i8dot`` takes the TPU kernel's integer branch (bits 8/4/2 only;
    ``i8dot_route`` gives the TPU program's choice). ``cluster`` fixes the
    CTAs per cluster (1..16, at most C); by default ``default_cluster``.

    CPU tensors take the plain version of the branch; CUDA tensors launch
    the kernel's, and any input it does not take raises."""
    name = "decode_attention"
    if bits not in BITS:
        raise ValueError(f"{name}: cache bits {bits} (takes {BITS})")
    if i8dot and bits not in I8DOT_BITS:
        raise ValueError(f"{name}: i8dot needs a quantized cache (bits {I8DOT_BITS})")
    if q.device.type == "cpu":
        plain = decode_attention_i8dot_plain if i8dot else decode_attention_plain
        return plain(q, k, v, k_scales, k_zeros, v_scales, v_zeros, mask, bits, need_attn)
    B, H, L, D = q.shape
    KVH, C = k.shape[1], k.shape[2]
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
        nc = default_cluster(B, KVH, C, G, bits, need_attn, i8dot)
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
        ptr(workspace), B, KVH, C, G, nc, bits, int(need_attn), int(bool(i8dot)),
        int(out_bf16), 1.0 / math.sqrt(D), _build.stream_ptr(q.device),
    )
    _build.check(status, name)
    LAUNCHES[variant(bits, need_attn, i8dot)] += 1
    return (out if out_bf16 else out.to(q.dtype)), pooled
