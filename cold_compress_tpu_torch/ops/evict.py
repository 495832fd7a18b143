"""Fused heavy-hitter eviction (kernel K7): wrapper and plain version.

Counterpart of ``cold_compress_tpu/ops/pallas_evict.py``. The CUDA kernel
(``csrc/hh_evict.cu``) replaces ``fused_hh_evict`` (pallas_evict.py:57) and
serves every heavy-hitter cache with history_window_size 1 (attention
thresholding changes only the observations, not this step). It computes ``avg = num / max(denom, 1)`` in f32, sets
protected slots (``pos < global`` or ``pos >= input_pos - recent``) to 1 and
empty slots (``pos == -1``) to 0, takes the argmin per (batch, head) row
(the first index on ties) and zeroes ``num`` and ``denom`` at that slot, in
place. Same f32 values and an exact argmin: bit-identical to the plain
version.

Bound on the H100: bytes, far below a microsecond at the main path's sizes;
the kernel replaces about ten eager launches per layer per decode step with
one. One block per (batch, head) row, whose 512 threads issue all their loads
(16-byte vectors, a scalar head and tail where C % 4 != 0) before computing.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Launch count of the CUDA kernel (incremented only where it launches).
LAUNCHES = {"hh_evict": 0}


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
