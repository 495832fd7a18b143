"""Plain PyTorch reference of Mellum2's served path, at the stated precisions.

Mellum2-12B-A2.5B (``configs/mellum2_12b_a2p5b.json``, the published
``config.json``): the dense reference's decoder (``reference/model.py``:
its precisions, its int4 and kv8 arithmetic, SnapKV and the heavy-hitter
cache, ``follow``) with three differences, each written out from the
published keys:

* every MLP is a mixture of experts (``num_experts`` 64,
  ``num_experts_per_tok`` 8, ``moe_intermediate_size`` 896,
  ``norm_topk_prob``, no shared expert): ``p = softmax(x W_r)`` over the 64
  experts in f32 (x the bf16 normed state, ``W_r`` the bf16 router; its
  f32 product with TF32 off), the top 8 ``w_e = p_e / sum p``, and
  ``out = sum_e w_e W2_e(silu(W1_e x) * W3_e x)``. Each expert is SwiGLU over
  int4 group-128 weights, rounded as the dense FFN rounds (bf16 products
  at prefill, W4A8 at decode, the gate and up results in bf16, silu and
  the product in bf16); the down projection's result enters the sum in
  bf16 at prefill and in f32 at decode (W4A8's f32 sum, before any bf16),
  and the sum runs in k order (descending weight), each product and sum
  rounded in f32, then rounds to bf16;
* ``layer_types``: a ``sliding_attention`` layer's query at position i sees
  keys j with ``i - 1024 < j <= i`` (``sliding_window``), and its cache
  holds exactly those keys (kv8, the stated cache, whatever policy the
  full layers take: the last 1024 prompt rows, then each step's key in
  place of the one that left the window); a ``full_attention`` layer is
  causal over everything, with SnapKV and the heavy-hitter cache;
* ``rope_parameters``: default rope at theta 5e5 on the sliding layers;
  YaRN on the full layers (factor 16 over 8192 original positions,
  beta_fast 32, beta_slow 1): ``inv_extra = theta^(-2k/128)``,
  ``inv_inter = inv_extra / 16``, correction dims ``128 ln(8192 /
  (beta 2 pi)) / (2 ln theta)`` floored (beta 32) and ceiled (beta 1),
  clamped to [0, 127], a linear ramp r between them over k,
  ``inv = inv_inter r + inv_extra (1 - r)``, and cos, sin times
  ``attention_factor`` 1.2772588722239782; in float64, rounded to f32
  once. Pairs rotate interleaved (the configuration file's ``assumed``).

It imports nothing of the program and nothing of the JAX package. Its own
f32 products of values that TF32 does not hold exactly (the router's) run
with TF32 off.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence

import torch

from .model import (BF16, OBS_LEN, QUERY_CHUNK, Reference as Dense, act_quant, fuse,
                    kv_quant, rms_norm, rope, unpack_int4)

FULL = "full_attention"
SLIDING = "sliding_attention"


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rope_table(n: int, hd: int, theta: float, yarn, device) -> torch.Tensor:
    """(cos, sin) [n, hd/2, 2] f32 from float64 angles: default rope, or
    YaRN with ``yarn`` = (factor, original positions, beta_fast, beta_slow,
    attention factor)."""
    k = torch.arange(0, hd, 2, dtype=torch.float64)
    inv = 1.0 / (theta ** (k / hd))
    scale = 1.0
    if yarn is not None:
        factor, orig, beta_fast, beta_slow, scale = yarn

        def dim(beta):
            return hd * math.log(orig / (beta * 2 * math.pi)) / (2 * math.log(theta))

        lo = max(math.floor(dim(beta_fast)), 0)
        hi = min(math.ceil(dim(beta_slow)), hd - 1)
        r = ((torch.arange(hd // 2, dtype=torch.float64) - lo) / (hi - lo)).clamp(0, 1)
        inv = inv / factor * r + inv * (1 - r)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    return (torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * scale).float().to(device)


def qmatmul_f32(x: torch.Tensor, q8: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                bits: int) -> torch.Tensor:
    """W4A``bits`` over int4 weights, f32 [P, OUT]: row p of x [P, IN]
    against weight p (``q8`` int8 [P, IN, OUT] holding q - 8, ``s`` and ``z``
    f32 [P, IN/gs, OUT]), or every row against one weight (``q8`` [IN, OUT],
    ``s``, ``z`` [IN/gs, OUT]; rows taken 256 at a time): x quantized per
    row, per group the exact integer dot and the row's sum,
    ``sx * sum_g (s_g d_g + z_g xs_g)``."""
    P, IN = x.shape
    shared = q8.dim() == 2
    if shared and P > 256:
        return torch.cat([qmatmul_f32(x[i:i + 256], q8, s, z, bits) for i in range(0, P, 256)])
    ng, OUT = s.shape[-2:]
    xq, sx = act_quant(x, bits)
    xg = xq.view(P, ng, 1, -1)  # [P, ng, 1, gs]
    q = q8.float().view(ng, -1, OUT) if shared else q8.float().view(P, ng, -1, OUT)
    d = torch.matmul(xg, q)[:, :, 0]  # exact integers
    return (d * s + xg.sum(-1) * z).sum(1) * sx


class Reference(Dense):
    """The model and cache policy of the configuration (``arch/mellum2.py``
    draws the weights): the dense reference's interface, precisions and
    ``control``; ``checked`` must be a full layer."""

    def __init__(self, dims, weights: dict, cache: dict, checked: int = 3):
        if not 0 <= int(checked) < len(weights["layers"]):
            raise ValueError(f"checked layer {checked} is not one of the model's "
                             f"{len(weights['layers'])} layers")
        if dims.layer_types[int(checked)] != FULL:
            raise ValueError(f"checked layer {checked} is a sliding layer")
        self.checked = int(checked)
        self.kv_bits, self.decode_bits, self.prefill_bits = 8, 8, None
        self.d = dims
        self.C = int(cache["max_cache_length"])
        self.global_tokens = int(cache["global_tokens"])
        self.recent = int(cache["recent_window"])
        self.emb = weights["tok_embeddings"]
        self.norm = weights["norm"]
        self.head = unpack_int4(weights["output"])
        self.layers = []
        for lp in weights["layers"]:
            a, m = lp["attn"], lp["moe"]
            q13, s13, z13, q2, s2, z2 = [], [], [], [], [], []
            for ex in m["experts"]:  # held as int8 q - 8 and f32 scales and zeros
                w13 = fuse([unpack_int4(ex["w1"]), unpack_int4(ex["w3"])])
                w2 = unpack_int4(ex["w2"])
                for dst, t in zip((q13, s13, z13), w13):
                    dst.append(t.to(torch.int8) if dst is q13 else t)
                for dst, t in zip((q2, s2, z2), w2):
                    dst.append(t.to(torch.int8) if dst is q2 else t)
                del w13, w2
            self.layers.append({
                "wqkv": fuse([unpack_int4(a[k]) for k in ("wq", "wk", "wv")]),
                "wo": unpack_int4(a["wo"]),
                "router": m["router"],
                "e13": tuple(torch.stack(t) for t in (q13, s13, z13)),
                "e2": tuple(torch.stack(t) for t in (q2, s2, z2)),
                "an": lp["attention_norm"], "fn": lp["ffn_norm"], "b": None,
            })
        self._tables = {}

    # -- pieces ------------------------------------------------------------

    def sliding(self, layer: int) -> bool:
        return self.d.layer_types[layer] == SLIDING

    def _rope_rows(self, pos: torch.Tensor, layer: int = 0) -> torch.Tensor:
        kind = SLIDING if self.sliding(layer) else FULL
        n = int(pos.max()) + 1
        t = self._tables.get(kind)
        if t is None or t.shape[0] < n:
            yarn = None if kind == SLIDING else self.d.yarn
            t = self._tables[kind] = rope_table(max(n, 2 * (0 if t is None else t.shape[0])),
                                                self.d.head_dim, self.d.rope_theta, yarn,
                                                pos.device)
        return t[pos]

    def _route(self, L: dict, h: torch.Tensor):
        """(ids [n, k], weights [n, k] f32) of bf16 rows h [n, D]."""
        with no_tf32():
            p = torch.softmax(h.float() @ L["router"].float(), dim=-1)
        w, ids = torch.topk(p, self.d.top_k, dim=-1)
        return ids, w / w.sum(dim=-1, keepdim=True)

    def _combine(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        acc = w[:, 0:1] * y[:, 0].float()
        for k in range(1, y.shape[1]):
            acc = acc + w[:, k:k + 1] * y[:, k].float()
        return acc.to(BF16)

    def _expert_dense(self, t, e: int) -> torch.Tensor:
        q, s, z = (x[e] for x in t)
        ng, OUT = s.shape
        return (q.float().view(ng, -1, OUT) * s[:, None] + z[:, None]).view(-1, OUT)

    def _ffn(self, L: dict, x: torch.Tensor, bits) -> torch.Tensor:
        """The experts' output for the bf16 residual rows x [n, D]."""
        h = rms_norm(x, L["fn"], self.d.norm_eps)
        ids, w = self._route(L, h)
        n, K = ids.shape
        F = self.d.expert_width
        if bits is None:  # prefill: bf16 products over each expert's dequantized weights
            y = torch.empty((n, K, h.shape[1]), dtype=BF16, device=h.device)
            for e in torch.unique(ids).tolist():
                tok, slot = (ids == e).nonzero(as_tuple=True)
                gu = h[tok] @ self._expert_dense(L["e13"], e).to(BF16)
                act = torch.nn.functional.silu(gu[:, :F]) * gu[:, F:]
                y[tok, slot] = act @ self._expert_dense(L["e2"], e).to(BF16)
            return self._combine(y, w)
        if n * K > 64:  # a prefill (the control's int8): expert by expert
            y = torch.empty((n, K, h.shape[1]), dtype=torch.float32, device=h.device)
            for e in torch.unique(ids).tolist():
                tok, slot = (ids == e).nonzero(as_tuple=True)
                q13, s13, z13 = (t[e] for t in L["e13"])
                gu = qmatmul_f32(h[tok], q13, s13, z13, bits).to(BF16)
                act = torch.nn.functional.silu(gu[:, :F]) * gu[:, F:]
                y[tok, slot] = qmatmul_f32(act, *(t[e] for t in L["e2"]), bits)
            return self._combine(y, w)
        # W4A``bits`` at decode: every (row, k) pair against its expert, in one batch
        flat = ids.reshape(-1)
        rows = h.repeat_interleave(K, dim=0)
        q13, s13, z13 = (t[flat] for t in L["e13"])
        gu = qmatmul_f32(rows, q13, s13, z13, bits).to(BF16)
        del q13
        act = torch.nn.functional.silu(gu[:, :F]) * gu[:, F:]
        q2, s2, z2 = (t[flat] for t in L["e2"])
        y = qmatmul_f32(act, q2, s2, z2, bits)
        return self._combine(y.view(n, K, -1), w)

    def _prefill_attention(self, q, k, v, window: int = 0):
        """The dense reference's causal attention, or with ``window`` the
        sliding layer's (no summaries: its cache keeps the last rows)."""
        if not window:
            return super()._prefill_attention(q, k, v)
        n = q.shape[0]
        d = self.d
        G = d.n_head // d.n_kv_head
        dev = q.device
        qg = q.float().permute(1, 0, 2).reshape(d.n_kv_head, G, n, d.head_dim)
        kf = k.float().permute(1, 0, 2)[:, None]
        vf = v.float().permute(1, 0, 2)[:, None]
        y = torch.empty((d.n_kv_head, G, n, d.head_dim), dtype=BF16, device=dev)
        for c0 in range(0, n, QUERY_CHUNK):
            c1 = min(n, c0 + QUERY_CHUNK)
            k0 = max(0, c0 - window + 1)
            qpos = torch.arange(c0, c1, device=dev)[:, None]
            kpos = torch.arange(k0, c1, device=dev)[None, :]
            s = (qg[:, :, c0:c1] @ kf[:, :, k0:c1].transpose(-1, -2)) * (
                1.0 / math.sqrt(d.head_dim))
            seen = (kpos <= qpos) & (kpos > qpos - window)
            p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
            y[:, :, c0:c1] = (p.to(BF16).float() @ vf[:, :, k0:c1]).to(BF16)
            del s, p
        return y.reshape(d.n_head, n, d.head_dim).permute(1, 0, 2).reshape(n, -1), None, None

    def _window_cache(self, k, v, n: int) -> dict:
        """A sliding layer's cache after prefill: the last W rows, position
        j at slot j mod W, quantized; empty slots where the prompt is
        shorter."""
        d, W = self.d, self.d.sliding_window
        dev = k.device
        st = {name: torch.zeros((d.n_kv_head, W, d.head_dim), device=dev) for name in ("ku", "vu")}
        st.update({name: torch.ones((d.n_kv_head, W), device=dev)
                   for name in ("ks", "kz", "vs", "vz")})
        st["pos"] = torch.full((d.n_kv_head, W), -1, dtype=torch.long, device=dev)
        st["num"] = torch.zeros((d.n_kv_head, W), device=dev)
        st["denom"] = torch.ones((d.n_kv_head, W), device=dev)
        kept = torch.arange(max(0, n - W), n, device=dev)
        slot = kept % W
        for name, x in (("k", k), ("v", v)):
            u, s, z = kv_quant(x[kept].permute(1, 0, 2), self.kv_bits)
            st[name + "u"][:, slot], st[name + "s"][:, slot], st[name + "z"][:, slot] = u, s, z
        st["pos"][:, slot] = kept
        return st

    # -- the two phases ----------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens: Sequence[int]):
        d = self.d
        dev = self.head[0].device
        ids = torch.tensor(list(tokens), dtype=torch.long, device=dev)
        n = ids.shape[0]
        x = self.emb[ids]
        arange = torch.arange(n, device=dev)
        bits = self.prefill_bits
        states: List[dict] = []
        for li, L in enumerate(self.layers):
            cs = self._rope_rows(arange, li)
            q, k, v = self._qkv(L, rms_norm(x, L["an"], d.norm_eps), bits)
            q, k = rope(q, cs), rope(k, cs)
            if li == self.checked:
                checked = self._checked_rows(k, v)
            window = d.sliding_window if self.sliding(li) else 0
            y, cum, obs = self._prefill_attention(q, k, v, window)
            x = x + self._linear(y, L["wo"], bits)
            x = x + self._ffn(L, x, bits)
            states.append(self._window_cache(k, v, n) if window
                          else self._compress(k, v, cum, obs, n))
            del q, k, v, y
        return self._logits(x[-1:])[0], states, checked

    @torch.no_grad()
    def decode(self, states: List[dict], tokens: torch.Tensor, pos: torch.Tensor):
        d = self.d
        B = tokens.shape[0]
        G = d.n_head // d.n_kv_head
        x = self.emb[tokens]
        bits = self.decode_bits
        rows = torch.arange(B, device=x.device)[:, None]
        heads = torch.arange(d.n_kv_head, device=x.device)[None, :]
        for li, (L, st) in enumerate(zip(self.layers, states)):
            cs = self._rope_rows(pos, li)[:, None]
            q, k, v = self._qkv(L, rms_norm(x, L["an"], d.norm_eps), bits)
            q, k = rope(q[:, None], cs)[:, 0], rope(k[:, None], cs)[:, 0]
            if li == self.checked:
                checked = self._checked_rows(k, v)
            spos = st["pos"]
            if self.sliding(li):  # the key that left the window: slot pos mod W
                idx = (pos % d.sliding_window)[:, None].expand(B, d.n_kv_head)
            else:  # heavy-hitter eviction
                avg = st["num"] / st["denom"].clamp_min(1.0)
                protected = (spos < self.global_tokens) | (spos >= pos[:, None, None] - self.recent)
                avg = torch.where(protected, 1.0, avg)
                avg = torch.where(spos == -1, 0.0, avg)
                idx = avg.argmin(dim=-1)
                st["num"][rows, heads, idx] = 0.0
                st["denom"][rows, heads, idx] = 0.0
            for name, t in (("k", k), ("v", v)):
                u, s, z = kv_quant(t, self.kv_bits)
                st[name + "u"][rows, heads, idx] = u
                st[name + "s"][rows, heads, idx] = s
                st[name + "z"][rows, heads, idx] = z
            spos[rows, heads, idx] = pos[:, None]
            y, pooled = self._decode_attention(q.view(B, d.n_kv_head, G, d.head_dim), st, spos)
            if not self.sliding(li):
                st["num"] += pooled
                st["denom"] += 1.0
            x = x + self._linear(y.reshape(B, -1), L["wo"], bits)
            x = x + self._ffn(L, x, bits)
        return self._logits(x), checked


__all__ = ["Reference", "rope_table", "qmatmul_f32", "OBS_LEN"]
