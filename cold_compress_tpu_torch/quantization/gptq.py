"""GPTQ: Hessian-based int4 weight quantization with calibration.

Port of ``cold_compress_tpu/quantization/gptq.py`` (Frantar et al.,
arXiv:2210.17323): an explicit layer-by-layer calibration forward that forms
each linear's input Hessian and quantizes its weight with error feedback
through the upper Cholesky factor of the inverse Hessian, propagating the
activations through the already-quantized layers. The leaves are those of
``weight_quant.quantize_weight_int4`` (group-wise affine uint4, rowpack), so
a GPTQ checkpoint runs on the same inference path.

``gptq_quantize_matrix`` follows the JAX package's dtypes, which numpy 2's
promotion rules set: the group statistics, codes and the dequantized row in
f32; the row's error in f64 (an f32 row divided by the f64 ``Hinv[i, i]``);
the update of the later rows formed and subtracted in f64, then rounded to
f32. Two forms:

  * ``blocked=False``, row by row, the contract (the JAX function's
    arithmetic, codes equal on the same W and H): each row's update lands
    on every later row at once;
  * ``blocked=True``, lazy batch: each row's update lands on the rows of
    its own group at once, and the rows after the group take the group's
    summed update in one f64 GEMM, ``W[g1:] -= Hinv[g0:g1, g1:]^T @ E``.
    A group's min and max are still taken after every earlier group's
    update, so this is the same arithmetic up to summation order and one
    f32 rounding per group instead of one per row (tests bound the
    difference). On the card a group's row loop replays as one CUDA graph.

``gptq_quantize_params`` runs on the device where the parameter tree lives
and takes the blocked form there on the card; its calibration attention is
``ops/attention.py::prefill_attention``, so shapes that pass the flash gate
run kernel K4 (in bf16, as on the TPU).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.rope import apply_rotary_emb
from ..models.transformer import rms_norm
from ..ops.attention import prefill_attention
from ..ops.linear import dequantize_weight
from .weight_quant import _const, effective_group_size, pack_int4

#: f64 elements of one slice of the trailing update (bounds its temporaries).
UPDATE_CHUNK = 1 << 27

#: Parts of ``gptq_quantize_params``' time that ``timings`` collects.
TIMED = ("forward", "hessian", "inverse", "groups")


@contextmanager
def _timed(timings: Optional[Dict[str, float]], key: str, device: torch.device):
    """Add the block's wall seconds to ``timings[key]`` (the card
    synchronized at both ends); nothing when ``timings`` is None."""
    if timings is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _group_stats(block: torch.Tensor, fifteen: torch.Tensor):
    """Per-column min, scale and zero of one group's rows (f32):
    ``s = max(mx - mn, 1e-6) / 15``, ``z = mn + 8 s``. ``fifteen`` is an f32
    tensor on the block's device (a true division on every device, made
    before any graph capture)."""
    mn = block.amin(dim=0)
    s = (block.amax(dim=0) - mn).clamp_min(1e-6) / fifteen
    return mn, s, mn + s * 8.0


def _row_step(rows, hrow, j, mn, s, z, q_out, err_out):
    """Quantize ``rows[j]`` into ``q_out`` and put its f64 error over
    ``hrow[j]`` (``Hinv[i, i]``) into ``err_out``; then subtract the f64
    update ``hrow[j+1:] x err`` from ``rows[j+1:]``, rounded to f32."""
    w = rows[j]
    q = torch.round((w - mn) / s).clamp_(0, 15)
    q_out.copy_(q)
    dq = (q - 8.0) * s + z
    torch.div((w - dq).double(), hrow[j], out=err_out)
    if j + 1 < rows.shape[0]:
        rest = rows[j + 1:]
        rest.copy_(rest.double() - torch.outer(hrow[j + 1:], err_out))


class _GroupLoop:
    """One group's row loop over static buffers (rows [gs, out] f32, the
    group's diagonal block of Hinv [gs, gs] f64; out: codes, scale, zero,
    errors), captured as one CUDA graph on first use and replayed per
    group."""

    def __init__(self, gs: int, out_dim: int, device: torch.device):
        f32, f64 = torch.float32, torch.float64
        self.rows = torch.zeros((gs, out_dim), dtype=f32, device=device)
        self.hblock = torch.eye(gs, dtype=f64, device=device)
        self.codes = torch.zeros((gs, out_dim), dtype=torch.uint8, device=device)
        self.errs = torch.zeros((gs, out_dim), dtype=f64, device=device)
        self.scale = torch.zeros((out_dim,), dtype=f32, device=device)
        self.zero = torch.zeros_like(self.scale)
        self.fifteen = _const(self.scale, 15.0)
        self.graph = None

    def _body(self):
        mn, s, z = _group_stats(self.rows, self.fifteen)
        self.scale.copy_(s)
        self.zero.copy_(z)
        for j in range(self.rows.shape[0]):
            _row_step(self.rows, self.hblock[j], j, mn, s, z, self.codes[j], self.errs[j])

    def run(self, rows: torch.Tensor, hblock: torch.Tensor) -> None:
        self.rows.copy_(rows)
        self.hblock.copy_(hblock)
        if self.graph is None:
            side = torch.cuda.Stream(self.rows.device)
            side.wait_stream(torch.cuda.current_stream(self.rows.device))
            with torch.cuda.stream(side):
                self._body()  # warm-up, outside the capture
            torch.cuda.current_stream(self.rows.device).wait_stream(side)
            self.rows.copy_(rows)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._body()
        self.graph.replay()


def _blocked_groups(W, Hinv, gs, Q, scales, zeros, loops):
    """The lazy-batch form over W in place (see the module docstring)."""
    in_dim, out_dim = W.shape
    on_card = W.device.type == "cuda"
    errs = None if on_card else torch.empty((gs, out_dim), dtype=torch.float64)
    fifteen = _const(W, 15.0)
    for gi, g0 in enumerate(range(0, in_dim, gs)):
        g1 = g0 + gs
        if on_card:
            key = (gs, out_dim, W.device.index)
            if key not in loops:
                loops[key] = _GroupLoop(gs, out_dim, W.device)
            loop = loops[key]
            loop.run(W[g0:g1], Hinv[g0:g1, g0:g1])
            Q[g0:g1].copy_(loop.codes)
            scales[gi].copy_(loop.scale)
            zeros[gi].copy_(loop.zero)
            errs = loop.errs
        else:
            rows = W[g0:g1]
            mn, s, z = _group_stats(rows, fifteen)
            scales[gi], zeros[gi] = s, z
            for j in range(gs):
                _row_step(rows, Hinv[g0 + j, g0:g1], j, mn, s, z, Q[g0 + j], errs[j])
        step = max(1, UPDATE_CHUNK // out_dim)
        for r0 in range(g1, in_dim, step):
            rest = W[r0:r0 + step]
            rest.copy_(rest.double() - Hinv[g0:g1, r0:r0 + step].T @ errs)


def _row_by_row(W, Hinv, gs, Q, scales, zeros):
    """The contract: each row's f64 update lands on every later row."""
    in_dim = W.shape[0]
    errs = torch.empty((W.shape[1],), dtype=torch.float64, device=W.device)
    fifteen = _const(W, 15.0)
    for gi, g0 in enumerate(range(0, in_dim, gs)):
        mn, s, z = _group_stats(W[g0:g0 + gs], fifteen)
        scales[gi], zeros[gi] = s, z
        for i in range(g0, g0 + gs):
            _row_step(W[i:], Hinv[i, i:], 0, mn, s, z, Q[i], errs)


def gptq_quantize_matrix(W: torch.Tensor, H: torch.Tensor, group_size: int = 128,
                         percdamp: float = 0.01, blocked: bool = False,
                         timings: Optional[Dict[str, float]] = None,
                         _loops: Optional[dict] = None) -> Dict[str, Any]:
    """Quantize W [in, out] group-wise along the input axis with error
    feedback through the upper Cholesky factor of ``inv(H)`` (H [in, in],
    about 2 X^T X), on W's device. Dead inputs (``H[i, i] == 0``) get a unit
    diagonal and zero weights; the diagonal is damped by ``percdamp`` times
    its mean. Returns the int4 leaf ``{"w", "scales", "zeros",
    "group_size"}`` of ``weight_quant.quantize_weight_int4``. ``timings``
    collects the seconds of "inverse" (inverse and Cholesky factor) and
    "groups" (the group loops and their updates)."""
    dev = W.device
    in_dim, out_dim = W.shape
    gs = effective_group_size(in_dim, group_size)
    with _timed(timings, "inverse", dev):
        W = W.to(torch.float32, copy=True)
        H = H.to(device=dev, dtype=torch.float64, copy=True)
        diag = H.diagonal()
        dead = diag == 0
        diag[dead] = 1.0
        W[dead] = 0.0
        # np.mean's pairwise sum, as the JAX function takes it.
        diag += percdamp * float(np.mean(diag.cpu().numpy()))
        Hinv = torch.linalg.cholesky(torch.linalg.inv(H), upper=True)
        del H, diag
    Q = torch.empty((in_dim, out_dim), dtype=torch.uint8, device=dev)
    scales = torch.empty((in_dim // gs, out_dim), dtype=torch.float32, device=dev)
    zeros = torch.empty_like(scales)
    with _timed(timings, "groups", dev):
        if blocked:
            _blocked_groups(W, Hinv, gs, Q, scales, zeros, {} if _loops is None else _loops)
        else:
            _row_by_row(W, Hinv, gs, Q, scales, zeros)
    return {
        "w": pack_int4(Q),
        "scales": scales.to(torch.bfloat16),
        "zeros": zeros.to(torch.bfloat16),
        "group_size": gs,
    }


def _hessian(x: torch.Tensor) -> torch.Tensor:
    """H = 2 X^T X over all calibration rows (x [..., in]): the product in
    f32, then cast to f64, as the JAX package forms it."""
    xf = x.float().reshape(-1, x.shape[-1])
    return (xf.T @ xf).double() * 2.0


def _split_columns(leaf: Dict[str, Any], widths) -> list:
    """Column slices of an int4 leaf (codes are packed along the input
    axis, so a column slice of each array is the slice's own leaf)."""
    out, c0 = [], 0
    for wd in widths:
        out.append({k: (v[:, c0:c0 + wd].contiguous() if torch.is_tensor(v) else v)
                    for k, v in leaf.items()})
        c0 += wd
    return out


@contextmanager
def _full_f32_matmuls():
    """f32 matmuls in full f32 (no TF32), as numpy's; restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


Observer = Callable[[Optional[int], str, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, Any]],
                    None]


def gptq_quantize_params(cfg: ModelConfig, params: Dict[str, Any], rope: torch.Tensor,
                         group_size: int = 128, n_samples: int = 8, seq_length: int = 512,
                         calibration_tokens: Optional[np.ndarray] = None, seed: int = 1234,
                         verbose: bool = True, timings: Optional[Dict[str, float]] = None,
                         observe: Optional[Observer] = None) -> Dict[str, Any]:
    """Quantize every linear of a dense parameter tree to int4 with GPTQ,
    the vocab head last and always to int4; embeddings, norms and biases
    carry through. ``calibration_tokens`` [n, L] ints, else
    ``RandomState(seed).randint(0, vocab, (n_samples, seq_length))`` (the
    JAX package's draw). The forward follows the JAX function: embedding,
    RMS norm, the quantized projections dequantized to f32 under f32
    matmuls, rope, causal attention through ``prefill_attention`` with
    every lane valid. wq|wk|wv share one Hessian and are quantized as one
    column-concatenated matrix (columns are independent under one H), as
    are w1|w3; the leaves come back split. The blocked form runs on the
    card, the row-by-row contract elsewhere.

    ``timings`` (a dict) collects the seconds of ``TIMED``; ``observe(layer,
    name, x, H, W, leaf)`` is called for each matrix after its quantization
    (``layer`` None for the head; x its calibration inputs [rows, in] f32,
    H their Hessian, W the dense weight, leaf the int4 leaf)."""
    emb = params["tok_embeddings"]
    dev = emb.device
    blocked = dev.type == "cuda"
    loops: dict = {}
    if calibration_tokens is None:
        rng = np.random.RandomState(seed)
        calibration_tokens = rng.randint(0, cfg.vocab_size, size=(n_samples, seq_length))
    tokens = torch.as_tensor(np.asarray(calibration_tokens), dtype=torch.long, device=dev)
    N, L = tokens.shape
    freqs = rope[:L].to(dev)
    H_, KVH, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim

    def lin(leaf, a, bias=None):
        w = dequantize_weight(leaf["w"], leaf["scales"], leaf["zeros"], leaf["group_size"],
                              torch.float32)
        out = a @ w
        return out if bias is None else out + bias.float()

    def quantize(li, names, ws, a):
        """One matrix (or a column-concatenation of ``ws`` under one
        Hessian) from inputs ``a``: the leaves, one per name."""
        with _timed(timings, "hessian", dev):
            H = _hessian(a)
        W = ws[0] if len(ws) == 1 else torch.cat(ws, dim=1)
        leaf = gptq_quantize_matrix(W, H, group_size, blocked=blocked, timings=timings,
                                    _loops=loops)
        del W
        leaves = _split_columns(leaf, [w.shape[1] for w in ws]) if len(ws) > 1 else [leaf]
        if observe is not None:
            for name, w, lf in zip(names, ws, leaves):
                observe(li, name, a.reshape(-1, a.shape[-1]), H, w, lf)
        return leaf, leaves

    with _full_f32_matmuls():
        with _timed(timings, "forward", dev):
            x = emb[tokens].float()  # [N, L, D]
        new_layers = []
        for li, lp in enumerate(params["layers"]):
            at, ff = lp["attn"], lp["ffn"]
            for w in (at["wq"], at["wk"], at["wv"], at["wo"], ff["w1"], ff["w3"], ff["w2"]):
                if not torch.is_tensor(w):
                    raise ValueError("GPTQ needs dense weights (a checkpoint not yet quantized)")
            with _timed(timings, "forward", dev):
                a = rms_norm(x, lp["attention_norm"], cfg.norm_eps).float()
            qkv, (wq_q, wk_q, wv_q) = quantize(li, ("wq", "wk", "wv"),
                                               (at["wq"], at["wk"], at["wv"]), a)
            with _timed(timings, "forward", dev):
                bias = None
                if "bq" in at:
                    bias = torch.cat([at["bq"].float(), at["bk"].float(), at["bv"].float()])
                y = lin(qkv, a, bias)
                Dq, Dkv = H_ * hd, KVH * hd
                q = apply_rotary_emb(y[..., :Dq].reshape(N, L, H_, hd), freqs)
                k = apply_rotary_emb(y[..., Dq:Dq + Dkv].reshape(N, L, KVH, hd), freqs)
                v = y[..., Dq + Dkv:].reshape(N, L, KVH, hd)
                del y
                y, _ = prefill_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    torch.ones((N, L), dtype=torch.bool, device=dev), L,
                )
                y = y.float().transpose(1, 2).reshape(N, L, -1)
                del q, k, v
            _, (wo_q,) = quantize(li, ("wo",), (at["wo"],), y)
            with _timed(timings, "forward", dev):
                x = x + lin(wo_q, y)
                b = rms_norm(x, lp["ffn_norm"], cfg.norm_eps).float()
                del a, y
            w13, (w1_q, w3_q) = quantize(li, ("w1", "w3"), (ff["w1"], ff["w3"]), b)
            with _timed(timings, "forward", dev):
                g = lin(w13, b)
                F = g.shape[-1] // 2
                # jax.nn.silu's formula, x * sigmoid(x).
                h = g[..., :F] * torch.sigmoid(g[..., :F]) * g[..., F:]
                del g, b
            _, (w2_q,) = quantize(li, ("w2",), (ff["w2"],), h)
            with _timed(timings, "forward", dev):
                x = x + lin(w2_q, h)
                del h
            attn = {"wq": wq_q, "wk": wk_q, "wv": wv_q, "wo": wo_q}
            for name in ("bq", "bk", "bv"):
                if name in at:
                    attn[name] = at[name]
            new_layers.append({
                "attn": attn,
                "ffn": {"w1": w1_q, "w3": w3_q, "w2": w2_q},
                "attention_norm": lp["attention_norm"],
                "ffn_norm": lp["ffn_norm"],
            })
            if verbose:
                print(f"  GPTQ: layer {li + 1}/{cfg.n_layer} done")

        out_p = params["output"]
        if out_p is not None:
            with _timed(timings, "forward", dev):
                xf = rms_norm(x, params["norm"], cfg.norm_eps).float()
            _, (out_p,) = quantize(None, ("output",), (out_p,), xf)
    loops.clear()
    return {
        "tok_embeddings": emb,
        "layers": new_layers,
        "norm": params["norm"],
        "output": out_p,
    }
