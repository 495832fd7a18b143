"""Fused heavy-hitter eviction (kernel K7), and decode's rotate-and-insert
built on it: wrappers and plain versions.

Counterpart of ``cold_compress_tpu/ops/pallas_evict.py``. The CUDA kernel
(``csrc/hh_evict.cu``) replaces ``fused_hh_evict`` (pallas_evict.py:57) and
serves every heavy-hitter cache with history_window_size 1 that the fused
insert below does not (attention thresholding changes only the observations,
not this step). It computes ``avg = num / max(denom, 1)`` in f32, sets
protected slots (``pos < global`` or ``pos >= input_pos - recent``) to 1 and
empty slots (``pos == -1``) to 0, takes the argmin per (batch, head) row
(the first index on ties) and zeroes ``num`` and ``denom`` at that slot, in
place. Same f32 values and an exact argmin: bit-identical to the plain
version.

Bound on the H100: bytes, far below a microsecond at the main path's sizes;
the kernel replaces about ten eager launches per layer per decode step with
one. One block per (batch, head) row, whose 512 threads issue all their loads
(16-byte vectors, a scalar head and tail where C % 4 != 0) before computing.

``hh_evict_insert`` is that eviction fused with its neighbours in a decode
step over a one-slot heavy-hitter kv8 cache at heads of 128 (the
strategy's ``rotate_insert`` takes it, ``caches/heavy_hitter.py``): rope on the G query rows and the K row of
each KV head, the kv8 quantization of the rotated K row and of the V row,
and the insert at the evicted slot (rows, scales, zeros, position, mask bit,
filled count), in one launch where the eager step took about 70 operations
a layer. Its plain version is that eager composite, and the kernel rounds
where it rounds: the same bits. With ``window=W`` it inserts into a
sliding-window layer's ring instead (``caches/window.py``): the slot is the
position mod W, given in place of the eviction search, and there is no
history (entry ``window_insert``, counter ``hh_evict_insert.window``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Launch count of the CUDA kernel (incremented only where it launches).
LAUNCHES = {"hh_evict": 0, "hh_evict_insert": 0, "hh_evict_insert.window": 0}


def hh_evict_plain(num, denom, pos, input_pos, global_tokens: int,
                   recent_window: int) -> torch.Tensor:
    """Plain PyTorch version, in place: returns idx [B, H] int32 and zeroes
    num [B, H, C] f32 and denom [B, H, C] int32 there. ``input_pos`` is
    [B, 1, 1] int32 (or broadcastable to it)."""
    avg = num / denom.clamp_min(1).float()
    protected = (pos < global_tokens) | (pos >= input_pos - recent_window)
    avg = torch.where(protected, 1.0, avg)
    avg = torch.where(pos == -1, 0.0, avg)
    idx = avg.argmin(dim=-1)  # the first minimum, as jnp.argmin
    index = idx[..., None]
    num.scatter_(2, index, 0.0)
    denom.scatter_(2, index, 0)
    return idx.to(torch.int32)


def _lib():
    fn = _build.library("hh_evict").hh_evict
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def hh_evict(num, denom, pos, input_pos, *, global_tokens: int,
             recent_window: int) -> torch.Tensor:
    """Heavy-hitter eviction step, in place (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    if num.device.type == "cpu":
        return hh_evict_plain(num, denom, pos, input_pos, global_tokens, recent_window)
    B, H, C = pos.shape
    for n, t, dt in (("num", num, torch.float32), ("denom", denom, torch.int32),
                     ("pos", pos, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (B, H, C) or not t.is_contiguous():
            raise ValueError(f"hh_evict: bad {n} {tuple(t.shape)} {t.dtype}")
        if t.device != num.device:
            raise ValueError(f"hh_evict: {n} on another device")
        if t.data_ptr() % 16:
            raise ValueError(f"hh_evict: {n} must start on a 16-byte boundary")
    if not isinstance(input_pos, torch.Tensor):  # a fill, not a copy from the host
        ipos = torch.full((1,), int(input_pos), dtype=torch.int32, device=num.device)
    else:
        ipos = input_pos.to(device=num.device, dtype=torch.int32)
    if ipos.numel() not in (1, B):
        raise ValueError(f"hh_evict: input_pos {tuple(ipos.shape)} for batch {B}")
    ipos = ipos.reshape(-1).expand(B).contiguous()
    idx = torch.empty((B, H), dtype=torch.int32, device=num.device)
    status = _lib()(
        num.data_ptr(), denom.data_ptr(), pos.data_ptr(), ipos.data_ptr(), idx.data_ptr(),
        B, H, C, int(global_tokens), int(recent_window), _build.stream_ptr(num.device),
    )
    _build.check(status, "hh_evict")
    LAUNCHES["hh_evict"] += 1
    return idx


def hh_evict_insert_plain(y, freqs, state, input_pos, n_head: int, n_kv_head: int,
                          window: int = 0):
    """Plain version of ``hh_evict_insert``, in place: the fused projection
    y [B, 1, (H + 2 KVH) hd] split and rotated (``models/rope.py``), the
    eviction (``hh_evict_plain``; with ``window`` the slot position mod
    ``window``) and the insert of the rotated K row and the V row
    (``caches/base.py::insert_rows``). Returns q [B, H, 1, hd] and idx
    [B, KVH] int32."""
    from ..caches.base import input_pos_b11, insert_rows
    from ..models.rope import split_rotate_qkv

    head_dim = y.shape[-1] // (n_head + 2 * n_kv_head)
    q, k, v = split_rotate_qkv(y, freqs, n_head, n_kv_head, head_dim)
    spec = state.spec
    ipos = input_pos_b11(input_pos, y.shape[0], state.pos.device)
    if window:
        idx = (ipos[:, :, 0].long() % window).expand(state.pos.shape[:2]).to(torch.int32)
    else:
        idx = hh_evict_plain(state.extra["attn_num"], state.extra["attn_denom"], state.pos,
                             ipos, spec.global_tokens, spec.recent_window)
    insert_rows(state, idx, ipos, k[:, :, 0], v[:, :, 0])
    return q, idx


def _insert_lib():
    fn = _build.library("hh_evict").hh_evict_insert
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _window_lib():
    fn = _build.library("hh_evict").window_insert
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def hh_evict_insert(y, freqs, state, input_pos, *, n_head: int, n_kv_head: int,
                    window: int = 0):
    """Decode's rotate, evict and insert for one layer's one-slot
    heavy-hitter kv8 cache ``state``, in place (see the module docstring);
    with ``window`` the insert into a sliding-window ring of that many
    slots (``state.pos``'s C) at the position mod ``window``.
    ``y`` [B, 1, (H + 2 KVH) 128] is the fused q|k|v projection, ``freqs``
    the rope rows [1 or B, 1, 64, 2] at the lanes' positions, ``input_pos``
    a 0-d or [B] tensor or an int. Returns q [B, H, 1, 128] and the
    evicted slots idx [B, KVH] int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    any input it does not take raises."""
    if y.device.type == "cpu":
        return hh_evict_insert_plain(y, freqs, state, input_pos, n_head, n_kv_head, window)
    B, H, C = state.pos.shape
    D = 128
    if state.spec.cache_bits != 8 or H != n_kv_head or n_head % H:
        raise ValueError(f"hh_evict_insert: {n_head} heads over a {state.spec.cache_bits}-bit "
                         f"cache of {H} KV heads")
    if window and window != C:
        raise ValueError(f"hh_evict_insert: a window of {window} over a ring of {C} slots")
    ex = state.extra
    rows = (B, H, C)
    history = {} if window else {
        "attn_num": (ex.get("attn_num"), torch.float32, rows, 16),
        "attn_denom": (ex.get("attn_denom"), torch.int32, rows, 16),
    }
    want = {  # name: (tensor, dtype, shape, alignment in bytes)
        "y": (y, torch.bfloat16, (B, 1, (n_head + 2 * H) * D), 8),
        "freqs": (freqs, torch.float32, tuple(freqs.shape), 8),
        **history,
        "pos": (state.pos, torch.int32, rows, 16),
        "mask": (state.mask, torch.bool, rows, 1),
        "cache_ct": (state.cache_ct, torch.int32, (B, H), 4),
        "k": (state.k, torch.uint8, rows + (D,), 4),
        "v": (state.v, torch.uint8, rows + (D,), 4),
        "k_scales": (state.k_scales, torch.float32, rows, 4),
        "k_zeros": (state.k_zeros, torch.float32, rows, 4),
        "v_scales": (state.v_scales, torch.float32, rows, 4),
        "v_zeros": (state.v_zeros, torch.float32, rows, 4),
    }
    for name, (t, dt, shape, align) in want.items():
        if t is None or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype)
            raise ValueError(f"hh_evict_insert: bad {name} {got}, takes {shape} {dt}")
        if t.device != y.device:
            raise ValueError(f"hh_evict_insert: {name} on another device")
        if t.data_ptr() % align:
            raise ValueError(f"hh_evict_insert: {name} must start on a {align}-byte boundary")
    if freqs.numel() not in (D, B * D) or tuple(freqs.shape[-2:]) != (D // 2, 2):
        raise ValueError(f"hh_evict_insert: rope rows {tuple(freqs.shape)} for batch {B}")
    if not isinstance(input_pos, torch.Tensor):  # a fill, not a copy from the host
        ipos = torch.full((1,), int(input_pos), dtype=torch.int32, device=y.device)
    else:
        ipos = input_pos.to(device=y.device, dtype=torch.int32).contiguous()
    if ipos.numel() not in (1, B):
        raise ValueError(f"hh_evict_insert: input_pos {tuple(ipos.shape)} for batch {B}")
    q = torch.empty((B, n_head, 1, D), dtype=torch.bfloat16, device=y.device)
    idx = torch.empty((B, H), dtype=torch.int32, device=y.device)
    strides = (B, H, n_head // H, C, y.shape[-1], 0 if freqs.numel() == D else D,
               0 if ipos.numel() == 1 else 1)
    if window:
        status = _window_lib()(
            y.data_ptr(), freqs.data_ptr(), ipos.data_ptr(), state.pos.data_ptr(),
            state.mask.data_ptr(), state.cache_ct.data_ptr(), state.k.data_ptr(),
            state.v.data_ptr(), state.k_scales.data_ptr(), state.k_zeros.data_ptr(),
            state.v_scales.data_ptr(), state.v_zeros.data_ptr(), q.data_ptr(), idx.data_ptr(),
            *strides, _build.stream_ptr(y.device),
        )
        _build.check(status, "window_insert")
        LAUNCHES["hh_evict_insert.window"] += 1
        return q, idx
    status = _insert_lib()(
        y.data_ptr(), freqs.data_ptr(), ipos.data_ptr(), ex["attn_num"].data_ptr(),
        ex["attn_denom"].data_ptr(), state.pos.data_ptr(), state.mask.data_ptr(),
        state.cache_ct.data_ptr(), state.k.data_ptr(), state.v.data_ptr(),
        state.k_scales.data_ptr(), state.k_zeros.data_ptr(), state.v_scales.data_ptr(),
        state.v_zeros.data_ptr(), q.data_ptr(), idx.data_ptr(),
        *strides, int(state.spec.global_tokens),
        int(state.spec.recent_window), _build.stream_ptr(y.device),
    )
    _build.check(status, "hh_evict_insert")
    LAUNCHES["hh_evict_insert"] += 1
    return q, idx
