#!/usr/bin/env python3
"""How far GPTQ's result moves under rounding-level changes, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/torch_gptq_sensitivity.py

Two measurements behind the bounds of ``tests/test_torch_gptq.py``:

1. The blocked (lazy-batch) form of the port's ``gptq_quantize_matrix``
   against its row-by-row form, on the test's five W/H cases, with the
   weights kept in f32 (as the port runs) and in f64: the share of codes
   that differ. In f64 the two forms are the same arithmetic up to
   summation order.
2. The JAX package's calibration (``cold_compress_tpu/quantization/gptq.py``)
   on the trained TinyByteLM fixture, group 64, with the port's row-by-row
   matrix function, as is and with one op of its forward at a time swapped
   for the port's (numpy's matmul of the projections, numpy's Hessian, the
   RMS norm, the attention, silu): the share of codes that differ from the
   stored JAX file, and each file's mean NLL of 96 teacher-forced bytes of
   real text (the first 400 bytes of BENCHMARK.md) under the port's
   forward, beside the JAX GPTQ file's and plain rounding's.

Torch runs at one thread, as the suite's tests do. One JSON row per
measurement.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cold_compress_tpu.models import transformer as JT  # noqa: E402
from cold_compress_tpu.quantization import gptq as JG  # noqa: E402
from cold_compress_tpu.runtime import engine as JE  # noqa: E402
from cold_compress_tpu_torch.caches import CacheSpec  # noqa: E402
from cold_compress_tpu_torch.models.config import ModelConfig  # noqa: E402
from cold_compress_tpu_torch.models import transformer as TT  # noqa: E402
from cold_compress_tpu_torch.ops.attention import prefill_attention  # noqa: E402
from cold_compress_tpu_torch.ops.qmm import unpack_rowpack  # noqa: E402
from cold_compress_tpu_torch.quantization import gptq as TG  # noqa: E402
from cold_compress_tpu_torch.runtime import engine as TE  # noqa: E402
from cold_compress_tpu_torch.runtime.generate import generate  # noqa: E402

FIXTURE = REPO / "tests" / "fixtures" / "TinyByteLM-hf"
CASES = [(256, 768, 64, 0), (768, 256, 64, 0), (1024, 512, 128, 0), (256, 128, 64, 2),
         (200, 96, 64, 0)]
SWAPS = ("none", "matmul", "hessian", "norm", "attention", "silu")


def row(**kw):
    print(json.dumps(kw), flush=True)


def calibration(IN, OUT, dead=0, seed=0):
    """tests/test_torch_gptq.py's correlated activations, W and Hessian."""
    rng = np.random.RandomState(seed)
    basis = rng.standard_normal((16, IN))
    x = (rng.standard_normal((4 * IN, 16)) @ basis
         + 0.1 * rng.standard_normal((4 * IN, IN))).astype(np.float32)
    x[:, 3:3 + dead] = 0.0
    W = (rng.standard_normal((IN, OUT)) * 0.05).astype(np.float32)
    return W, JG._hessian(x)


def blocked_against_rows(W, H, gs, dtype):
    """Share of codes where the two forms differ, with W held in ``dtype``
    (the inverse factor as ``gptq_quantize_matrix`` forms it)."""
    gs = TG.effective_group_size(W.shape[0], gs)
    W = torch.from_numpy(W).to(dtype)
    H = torch.from_numpy(H).clone()
    diag = H.diagonal()
    dead = diag == 0
    diag[dead] = 1.0
    W[dead] = 0.0
    diag += 0.01 * float(np.mean(diag.numpy()))
    Hinv = torch.linalg.cholesky(torch.linalg.inv(H), upper=True)
    codes = []
    for blocked in (False, True):
        Wc, Q = W.clone(), torch.empty(W.shape, dtype=torch.uint8)
        scales = torch.empty((W.shape[0] // gs, W.shape[1]), dtype=W.dtype)
        zeros = torch.empty_like(scales)
        if blocked:
            TG._blocked_groups(Wc, Hinv, gs, Q, scales, zeros, {})
        else:
            TG._row_by_row(Wc, Hinv, gs, Q, scales, zeros)
        codes.append(Q)
    return float((codes[0] != codes[1]).float().mean())


def calibrate(swapped, stored):
    """The JAX package's calibration (its ops: jnp norm, rope and attention,
    numpy matmuls and Hessians, jax.nn.silu) on the fixture, with the port's
    row-by-row matrix function, and with the one op ``swapped`` the port's
    (``none``: the JAX package's own result, which must equal the stored
    file). Returns the flat tree: ``stored``'s embeddings and norms, the
    calibration's quantized leaves."""
    from cold_compress_tpu.models.rope import apply_rotary_emb
    from cold_compress_tpu.ops.attention import prefill_attention as jax_prefill_attention
    from cold_compress_tpu_torch.ops.linear import dequantize_weight

    def t(a):
        return torch.from_numpy(np.array(a))  # a writable copy

    cfg, params, rope = JE.load_model(str(FIXTURE / "model.npz"))
    tokens = np.random.RandomState(1234).randint(0, cfg.vocab_size, size=(10, 512))
    N, L = tokens.shape
    hd, H, KVH = cfg.head_dim, cfg.n_head, cfg.n_kv_head

    def norm(x, w):
        if swapped == "norm":
            return TT.rms_norm(t(x), t(np.asarray(w, np.float32)).to(torch.bfloat16),
                               cfg.norm_eps).float().numpy()
        return np.asarray(JT.rms_norm(jnp.asarray(x), w, cfg.norm_eps), np.float32)

    def hessian(x):
        return TG._hessian(t(x)).numpy() if swapped == "hessian" else JG._hessian(x)

    def lin(leaf, a):
        w = dequantize_weight(leaf["w"], leaf["scales"], leaf["zeros"], leaf["group_size"],
                              torch.float32)
        return (t(a) @ w).numpy() if swapped == "matmul" else a @ w.numpy()

    def attention(q, k, v):
        if swapped == "attention":
            y, _ = prefill_attention(t(q).transpose(1, 2), t(k).transpose(1, 2),
                                     t(v).transpose(1, 2), torch.ones((N, L), dtype=torch.bool),
                                     L)
            return y.float().transpose(1, 2).reshape(N, L, -1).numpy()
        y, _ = jax_prefill_attention(
            jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3),
            jnp.asarray(v).transpose(0, 2, 1, 3), jnp.ones((N, L), bool), jnp.int32(L))
        return np.asarray(y, np.float32).transpose(0, 2, 1, 3).reshape(N, L, -1)

    def silu(g):
        if swapped == "silu":
            return (t(g) * torch.sigmoid(t(g))).numpy()
        return np.asarray(jax.nn.silu(jnp.asarray(g)))

    def rot(q):
        return np.asarray(apply_rotary_emb(jnp.asarray(q), rope[:L]))

    def quant(W, Hs):
        return TG.gptq_quantize_matrix(t(np.asarray(W, np.float32)), t(Hs), 64)

    flat = dict(stored)
    x = np.asarray(JT._embed(params, jnp.asarray(tokens, jnp.int32)), np.float32)
    for li, lp in enumerate(params["layers"]):
        at, ff = lp["attn"], lp["ffn"]
        a = norm(x, lp["attention_norm"])
        Hs = hessian(a)
        wq, wk, wv = (quant(at[n], Hs) for n in ("wq", "wk", "wv"))
        q = rot(lin(wq, a).reshape(N, L, H, hd))
        k = rot(lin(wk, a).reshape(N, L, KVH, hd))
        y = attention(q, k, lin(wv, a).reshape(N, L, KVH, hd))
        wo = quant(at["wo"], hessian(y))
        x = x + lin(wo, y)
        b = norm(x, lp["ffn_norm"])
        Hs = hessian(b)
        w1, w3 = quant(ff["w1"], Hs), quant(ff["w3"], Hs)
        h = silu(lin(w1, b)) * lin(w3, b)
        w2 = quant(ff["w2"], hessian(h))
        x = x + lin(w2, h)
        for name, leaf in (("attn/wq", wq), ("attn/wk", wk), ("attn/wv", wv), ("attn/wo", wo),
                           ("ffn/w1", w1), ("ffn/w3", w3), ("ffn/w2", w2)):
            flat.update(TE.flatten_params(leaf, f"layers/{li}/{name}/"))
    xf = norm(x, params["norm"])
    flat.update(TE.flatten_params(quant(params["output"], hessian(xf)), "output/"))
    return flat


def forced_nll(flat, text):
    cfg = ModelConfig.from_name(FIXTURE.name)
    model = TE.build_model(cfg, TE.params_from_flat(flat, "cpu", torch.bfloat16), "cpu",
                           max_positions=512)
    spec = dict(cache_strategy="full", max_cache_length=512, max_seq_length=512)
    caches = TT.init_caches(cfg, [CacheSpec(**spec) for _ in range(cfg.n_layer)], 1,
                            torch.bfloat16, device="cpu")
    prompt, forced = text[:256], text[256:352]
    _, info, _ = generate(model, caches, prompt, len(forced), next_tokens=forced,
                          prefill_bucket=512)
    probs = np.asarray(info["emitted_probs"], np.float64)[: len(forced)]
    return float(np.mean(-np.log(np.maximum(probs, 1e-20))))


def code_share(ref, got):
    n = d = 0
    for key in ref:
        if key.endswith("/w") and key[:-1] + "qmeta" in ref:
            a = unpack_rowpack(torch.from_numpy(ref[key]))
            b = unpack_rowpack(torch.from_numpy(np.asarray(got[key])))
            d += int((a != b).sum())
            n += a.numel()
    return d / n


def main() -> int:
    torch.set_num_threads(1)
    for IN, OUT, gs, dead in CASES:
        W, H = calibration(IN, OUT, dead)
        row(part="blocked vs row by row", IN=IN, OUT=OUT, group=gs, dead=dead,
            codes_f32=blocked_against_rows(W, H, gs, torch.float32),
            codes_f64=blocked_against_rows(W, H, gs, torch.float64))
    text = list((REPO / "BENCHMARK.md").read_text().encode("utf-8")[:400])
    with np.load(FIXTURE / "model_int4-gptq.g64.npz") as f:
        ref = {k: f[k] for k in f.files}
    for name in ("model_int4-gptq.g64.npz", "model_int4.g64.npz"):
        with np.load(FIXTURE / name) as f:
            row(part="stored file", file=name, nll=forced_nll({k: f[k] for k in f.files}, text))
    for name in SWAPS:
        flat = calibrate(name, ref)
        row(part="JAX calibration, one op the port's", swapped=name,
            codes=code_share(ref, flat), nll=forced_nll(flat, text))
    return 0


if __name__ == "__main__":
    sys.exit(main())
