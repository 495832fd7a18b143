"""Decode attention over the int8 KV cache (kernel K3): wrapper and plain
version.

Counterpart of ``cold_compress_tpu/ops/pallas_decode_attn.py``. The CUDA
kernel (``csrc/kv8_decode_attn.cu``) replaces the one-shot ``_kernel`` of
``quantized_decode_attention`` (pallas_decode_attn.py:899) at bits=8 with
need_attn=True, in its ``i8dot=False`` branch: the cache is dequantized
(``u8 * s + (z - 128 s)``, rounded to bf16) inside the kernel, scores and
softmax are f32, the probabilities are cast to bf16 before P.V, and the
probabilities averaged over the G query heads are returned for the
heavy-hitter history. The TPU's default for int8 caches, ``i8dot`` (int8
query and probabilities on the MXU), is a TPU-specific trick and stays a
later option.

Bound on the H100: bytes (K and V of every KV head, 2*C*D bytes each, plus
the per-slot scale/zero/mask). Design: the cache is split over C into
128-slot chunks, one block each, so that batch 1 still fills the card;
three launches per call (scores and per-chunk softmax statistics; the
final (m, l), exact pooled probabilities and partial P.V; the sum of the
partials over the chunks), all sums in a fixed order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

NEG_INF = -1e30

#: Launch count of the CUDA kernel (incremented only where it launches).
LAUNCHES = {"kv8_decode_attention": 0}

HEAD_DIM = 128
MAX_GROUP = 8


def decode_attn_supported(q_shape, n_kv_head: int) -> bool:
    """Shapes the kernel takes: one query token, head_dim 128, G <= 8."""
    B, H, L, D = q_shape
    return L == 1 and D == HEAD_DIM and H // n_kv_head <= MAX_GROUP


def kv8_decode_attention_plain(q, kq, vq, k_scales, k_zeros, v_scales, v_zeros,
                               mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: returns (out [B, H, 1, D] in q's dtype,
    pooled [B, KVH, 1, C] f32)."""
    B, H, _, D = q.shape
    KVH, C = kq.shape[1], kq.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qb = q.reshape(B, KVH, G, D).to(torch.bfloat16).float()

    def deq(u, s, z):
        zp = z - 128.0 * s
        return (u.float() * s[..., None] + zp[..., None]).to(torch.bfloat16).float()

    k = deq(kq, k_scales, k_zeros)
    v = deq(vq, v_scales, v_zeros)
    s = torch.einsum("bkgd,bkcd->bkgc", qb, k) * scale
    s = s.masked_fill(~mask[:, :, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    pooled = probs.sum(dim=2) * (1.0 / G)
    o = torch.einsum("bkgc,bkcd->bkgd", probs.to(torch.bfloat16).float(), v)
    out = o.reshape(B, H, 1, D).to(q.dtype)
    return out, pooled[:, :, None, :]


def _lib():
    lib = _build.library("kv8_decode_attn")
    fn, ws = lib.kv8_decode_attention, lib.kv8_decode_attention_workspace
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 4
        ws.restype = ctypes.c_size_t
    return fn, ws


def kv8_decode_attention(q, kq, vq, k_scales, k_zeros, v_scales, v_zeros, mask):
    """Returns (out [B, H, 1, D], pooled attn [B, KVH, 1, C]), the contract
    of gqa_attention's decode path with ``return_attn``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    if q.device.type == "cpu":
        return kv8_decode_attention_plain(
            q, kq, vq, k_scales, k_zeros, v_scales, v_zeros, mask
        )
    B, H, L, D = q.shape
    KVH, C = kq.shape[1], kq.shape[2]
    G = H // KVH
    if L != 1 or D != HEAD_DIM or G > MAX_GROUP or H % KVH:
        raise ValueError(f"kv8_decode_attention: unsupported q {tuple(q.shape)}")
    for name, t, dt, shape in (
        ("kq", kq, torch.uint8, (B, KVH, C, D)),
        ("vq", vq, torch.uint8, (B, KVH, C, D)),
        ("k_scales", k_scales, torch.float32, (B, KVH, C)),
        ("k_zeros", k_zeros, torch.float32, (B, KVH, C)),
        ("v_scales", v_scales, torch.float32, (B, KVH, C)),
        ("v_zeros", v_zeros, torch.float32, (B, KVH, C)),
        ("mask", mask, torch.bool, (B, KVH, C)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kv8_decode_attention: bad {name} {tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"kv8_decode_attention: {name} on another device")
    qb = q.to(torch.bfloat16).contiguous()  # the TPU kernel casts q too
    launch, workspace_floats = _lib()
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=q.device)
    pooled = torch.empty((B, KVH, 1, C), dtype=torch.float32, device=q.device)
    # Scores, per-chunk statistics and partial outputs between the launches.
    workspace = torch.empty(workspace_floats(B, KVH, C, G), dtype=torch.float32,
                            device=q.device)
    status = launch(
        qb.data_ptr(), kq.data_ptr(), vq.data_ptr(), k_scales.data_ptr(),
        k_zeros.data_ptr(), v_scales.data_ptr(), v_zeros.data_ptr(),
        mask.data_ptr(), out.data_ptr(), pooled.data_ptr(), workspace.data_ptr(),
        B, KVH, C, G, 1.0 / math.sqrt(D), _build.stream_ptr(q.device),
    )
    _build.check(status, "kv8_decode_attention")
    LAUNCHES["kv8_decode_attention"] += 1
    return out.to(q.dtype), pooled
