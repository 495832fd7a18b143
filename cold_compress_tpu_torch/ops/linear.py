"""Linear projections over dense, int4 group-wise or int8 weights.

Counterpart of ``cold_compress_tpu/ops/linear.py``. Dense weights are
``[in, out]`` tensors, as in the JAX package. An int4 weight arrives in the
checkpoint's rowpack layout (``QuantizedWeight`` there: int8 ``[in/2, out]``,
low nibble = row r unsigned, high nibble = row r + in/2 stored as signed
q - 8; bf16 scales/zeros ``[in/gs, out]``; ``dequant = (q - 8) * s + z``) and
is repacked once into the W4A8 kernel's layout (``ops/qmm.py``).

``QuantizedLinear`` dispatches by the number of rows L, as the JAX package's
``linear`` does on the TPU: L <= 32 goes to the W4A8 kernel (K1/K2); larger L
(prefill) dequantizes one layer to bf16 and calls ``torch.matmul``, or, with
``prefill_w4a8=True`` (the explicit counterpart of the JAX package's opt-in
``CCT_PREFILL_W4A8=1``, pallas_qmm.py:1154), goes to the W4A8 prefill
kernel (K8), which quantizes the activations to int8 as K1 does.

An int8 weight (``{"kind": "int8", "w": int8 [in, out], "scales": f32
[out]}``: the ``--head_bits 8`` vocab head, or every projection of an int8
checkpoint) becomes an ``Int8Linear``: L <= 32 goes to the W8A8 kernel (K9),
which forms ``(d * s) * sx`` where the JAX package's XLA ``w8a8_matmul``
forms ``(d * sx) * s`` (one f32 rounding apart); larger L dequantizes to
bf16 for ``torch.matmul``, as the JAX package's int8 path does at prefill.
Dense (bf16) weights go to ``torch.matmul``, as the JAX package's XLA dots.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import qmm

#: Row count up to which a quantized projection runs its decode kernel.
KERNEL_MAX_ROWS = 32


def dequantize_weight(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                      group_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [in, out] from a rowpack int4 weight: ``(q - 8) * s + z`` in
    f32, cast once to ``dtype``."""
    q = qmm.unpack_rowpack(w).float()  # [in, out]
    IN, OUT = q.shape
    q = q.reshape(IN // group_size, group_size, OUT)
    out = (q - 8.0) * scales.float()[:, None, :] + zeros.float()[:, None, :]
    return out.reshape(IN, OUT).to(dtype)


class DenseLinear(nn.Module):
    """``x @ weight (+ bias)`` with weight [in, out]."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, self.weight.dtype)
        y = torch.matmul(x.to(ct), self.weight.to(ct)).to(x.dtype)
        return _add_bias(y, self.bias)


class QuantizedLinear(nn.Module):
    """int4 group-wise weight held in the W4A8 kernel's layout.

    ``w`` uint8 [out, in/2] and ``sz`` bf16 [out, in/gs, 2]. ``counter``
    names the launch counter (``qmm.LAUNCHES``) the decode kernel
    increments: the projection it serves (``w4a8_gemv.<name>``); K8 counts
    under ``w4a8_gemm.<name>``. ``prefill_w4a8`` sends L > 32 rows to K8
    instead of the bf16 dequantization.
    """

    def __init__(self, w: torch.Tensor, sz: torch.Tensor, group_size: int,
                 bias: Optional[torch.Tensor] = None, *, counter: str,
                 prefill_w4a8: bool = False):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("sz", sz)
        self.register_buffer("bias", bias)
        self.group_size = group_size
        self.counter = counter
        self.prefill_w4a8 = prefill_w4a8

    @classmethod
    def from_rowpack(cls, w, scales, zeros, group_size, bias=None, *,
                     counter: str, prefill_w4a8: bool = False) -> "QuantizedLinear":
        wg, sz = qmm.rowpack_to_gemv(w, scales, zeros)
        return cls(wg, sz, group_size, bias=bias, counter=counter, prefill_w4a8=prefill_w4a8)

    @property
    def in_features(self) -> int:
        return self.w.shape[1] * 2

    @property
    def out_features(self) -> int:
        return self.w.shape[0]

    def dense(self, dtype=torch.bfloat16) -> torch.Tensor:
        return qmm.dequantize_gemv(self.w, self.sz, self.group_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[0] <= KERNEL_MAX_ROWS:
            y = qmm.w4a8_gemv(x2.contiguous(), self.w, self.sz, self.group_size,
                              counter=self.counter).to(x.dtype)
        elif self.prefill_w4a8:
            y = qmm.w4a8_gemm(x2.contiguous(), self.w, self.sz, self.group_size,
                              counter=self.counter.replace("w4a8_gemv", "w4a8_gemm")).to(x.dtype)
        else:
            y = torch.matmul(x2, self.dense(x.dtype))
        return _add_bias(y.reshape(*lead, y.shape[-1]), self.bias)


class Int8Linear(nn.Module):
    """int8 weight with per-column scales, held in the W8A8 kernel's layout:
    ``w`` int8 [out, in] and ``s`` f32 [out]. ``counter`` names the launch
    counter (``qmm.LAUNCHES``) the kernel increments."""

    def __init__(self, w: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, counter: str):
        super().__init__()
        wt, s = qmm.int8_to_gemv(w, scales)
        self.register_buffer("w", wt)
        self.register_buffer("s", s)
        self.register_buffer("bias", bias)
        self.counter = counter

    def dense(self, dtype=torch.bfloat16) -> torch.Tensor:
        return qmm.dequantize_int8(self.w, self.s, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if x2.shape[0] <= KERNEL_MAX_ROWS:
            y = qmm.w8a8_gemv(x2.contiguous(), self.w, self.s, counter=self.counter)
            y = y.to(x.dtype)
        else:
            y = torch.matmul(x2, self.dense(x.dtype))
        return _add_bias(y.reshape(*lead, y.shape[-1]), self.bias)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)

