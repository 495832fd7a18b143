"""Plain PyTorch reference of the served path, at the stated precisions.

What it computes is what the configuration states, written out from the
published layer equations, the cache policy's definition and the stated
precision of every operand, with no kernel, no padding and no buffer of the
program:

* a Llama-style decoder block (RMSNorm, rotary embeddings on interleaved
  pairs, grouped-query attention, SwiGLU), with q/k/v biases where the
  configuration has them;
* bf16 activations: the residual stream, every projection's output, the
  norms (normalised in f32, rounded, then scaled), the rotations (in f32,
  rounded), SwiGLU and the residual adds are bf16 values;
* int4 group-wise weights, dequantized here from the benchmark's raw bytes
  as ``(q - 8) * scale + zero`` in f32; at prefill they are rounded to bf16
  for a bf16 product (f32 sums, bf16 result);
* at decode, and for the vocabulary head, activations quantized per row to
  int8 (``W4A8``: ``sx = absmax * (1/127)``, round half to even, clip to
  127), the integer products summed in f32 and scaled, then rounded to
  bf16; the logits are those bf16 values;
* a KV cache of ``kv_bits`` per value (``u = round((x - min) / s)``,
  ``s = (max - min) / (2^bits - 1)``, zero ``min + s * 2^(bits-1)``);
* decode attention over the int8 cache as integer dots: q quantized per row
  to int8, f32 scores and softmax, ``p * s_v`` quantized per row to int8
  for the value sum, plus ``sum p * zero``; over a 4-bit cache (the
  control's) the cache is dequantized to bf16 and the probabilities rounded
  to bf16 before the value sum;
* prefill: causal attention with f32 scores and softmax, the normalised
  probabilities rounded to bf16 before the value sum (the port's kernel
  rounds them unnormalised, tile by tile: a difference of the last bf16
  place); then SnapKV keeps the
  global tokens, the last 16 prompt positions and the top-C of the rest by
  the observation window's attention pooled over 5 keys; the heavy-hitter
  history starts at each kept key's mean attention;
* decode: insert before attend; heavy-hitter eviction takes the slot of
  least mean attention, protecting the global tokens and the recent window,
  then adds the step's attention (averaged over each KV head's queries).

It imports nothing of the program and nothing of the JAX package. Its float32
matmuls multiply bf16 values or small integers, which TF32 holds exactly
(``tf32``).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch

OBS_LEN = 16
POOL = 5
QUERY_CHUNK = 512
BF16 = torch.bfloat16
NEG_INF = -1e30


@contextlib.contextmanager
def tf32():
    """float32 matmuls on TF32 for the duration: exact here, since every
    operand of one is a bf16 value or a small integer, and the sums are
    f32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def unpack_int4(leaf: dict):
    """A raw int4 leaf as (q - 8 [in, out], scale [in/gs, out], zero
    [in/gs, out]), all f32: bytes [in/2, out] whose low nibble is row r
    (unsigned) and high nibble row r + in/2 (signed q - 8); bf16 scales and
    zeros."""
    b = leaf["w"].to(torch.int16)
    q = torch.cat([(b & 15) - 8, b >> 4], dim=0).float()
    return q, leaf["scales"].float(), leaf["zeros"].float()


def dense(w) -> torch.Tensor:
    """f32 [in, out] of an unpacked int4 weight: ``(q - 8) * s + z``."""
    q, s, z = w
    ng, OUT = s.shape
    return (q.view(ng, -1, OUT) * s[:, None] + z[:, None]).view(-1, OUT)


def fuse(ws):
    """Unpacked weights side by side along the output axis."""
    return tuple(torch.cat(parts, dim=1) for parts in zip(*ws))


def act_quant(x: torch.Tensor, bits: int, floor: float = 1e-8):
    """Per-row symmetric quantization of x (any float type) to ``bits``:
    (integer values as f32, the row scale f32 [..., 1]); a row's absmax is
    taken at least ``floor``."""
    xf = x.float()
    top = 2 ** (bits - 1) - 1
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(floor) * (1.0 / top)
    return torch.round(xf / sx).clamp(-top, top), sx


#: Rows of x per group-wise product (bounds its [groups, rows, out] sums).
QMM_ROWS = 256


def qmatmul(x: torch.Tensor, w, bits: int) -> torch.Tensor:
    """W4A``bits`` over an unpacked int4 weight: x's rows quantized, per
    group g the integer dot ``d_g = sum xq (q - 8)`` and ``xs_g = sum xq``,
    ``y = sx * sum_g (s_g d_g + z_g xs_g)`` in f32; bf16 [rows, out]."""
    if x.shape[0] > QMM_ROWS:
        return torch.cat([qmatmul(x[i:i + QMM_ROWS], w, bits)
                          for i in range(0, x.shape[0], QMM_ROWS)])
    q, s, z = w
    ng, OUT = s.shape
    xq, sx = act_quant(x, bits)
    xg = xq.view(xq.shape[0], ng, -1).transpose(0, 1)  # [ng, L, gs]
    d = torch.bmm(xg, q.view(ng, -1, OUT))  # [ng, L, OUT], exact integers
    return ((d * s[:, None] + xg.sum(-1)[..., None] * z[:, None]).sum(0) * sx).to(BF16)


def kv_quant(x: torch.Tensor, bits: int):
    """Per-row affine quantization over the head dimension: (unsigned codes
    as f32, scale [...], zero [...]), ``x ~ (u - 2^(bits-1)) * s + z``."""
    xf = x.float()
    mn = xf.amin(dim=-1)
    top = 2 ** bits - 1
    s = (xf.amax(dim=-1) - mn).clamp_min(1e-6) / top
    u = torch.round((xf - mn[..., None]) / s[..., None]).clamp(0, top)
    return u, s, mn + s * 2 ** (bits - 1)


def kv_value(u: torch.Tensor, s: torch.Tensor, z: torch.Tensor, bits: int) -> torch.Tensor:
    """The values a cache row of codes u, scale s and zero z holds, f32."""
    return (u - 2 ** (bits - 1)) * s[..., None] + z[..., None]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16 x normalised in f32, rounded to bf16, then scaled by the bf16
    weight."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)).to(BF16) * w


def rope_table(n: int, hd: int, base: float, device) -> torch.Tensor:
    """(cos, sin) [n, hd/2, 2] in f32, from float64 angles."""
    inv = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).float().to(device)


def rope(x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (2i, 2i + 1) of bf16 x [..., n, heads, hd] by the table
    rows cs [..., n, hd/2, 2], in f32; bf16 result."""
    xf = x.float().unflatten(-1, (-1, 2))
    cos, sin = cs[..., None, :, 0], cs[..., None, :, 1]
    x0, x1 = xf[..., 0], xf[..., 1]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).flatten(-2).to(BF16)


def avg_pool(x: torch.Tensor, kernel: int = POOL) -> torch.Tensor:
    """Same-length mean over a window of ``kernel`` keys; a window cut by
    an end divides by the keys it holds."""
    half = kernel // 2
    n = x.shape[-1]
    csum = torch.nn.functional.pad(torch.cumsum(x, dim=-1), (1, 0))
    idx = torch.arange(n, device=x.device)
    lo = (idx - half).clamp_min(0)
    hi = (idx + half).clamp(max=n - 1) + 1
    return (csum[..., hi] - csum[..., lo]) / (hi - lo).to(x.dtype)


def softmax_rows(s: torch.Tensor) -> torch.Tensor:
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class Reference:
    """The model and cache policy of one configuration at its stated
    precisions, over the benchmark's raw weights (see ``portbench/arch/dense.py``
    for the tree). ``kv_bits`` is the cache's precision (the stated 8),
    ``decode_bits`` that of the activations into every projection at decode
    and into the head (the stated int8 of W4A8), ``prefill_bits`` that of
    the activations into the projections at prefill (None: the stated
    bf16). ``control()`` sets each one step below what the configuration
    states. ``checked`` is the layer whose cache ``follow`` returns (the
    architecture's ``checked_layer``)."""

    def __init__(self, dims, weights: dict, cache: dict, checked: int = 0):
        self.checked = int(checked)
        if not 0 <= self.checked < len(weights["layers"]):
            raise ValueError(f"checked layer {self.checked} is not one of the model's "
                             f"{len(weights['layers'])} layers")
        self.kv_bits = 8
        self.decode_bits = 8
        self.prefill_bits: Optional[int] = None
        self.d = dims
        self.C = int(cache["max_cache_length"])
        self.global_tokens = int(cache["global_tokens"])
        self.recent = int(cache["recent_window"])
        self.emb = weights["tok_embeddings"]  # bf16, gathered row by row
        self.norm = weights["norm"]
        self.head = unpack_int4(weights["output"])
        self.layers = []
        for lp in weights["layers"]:
            a, f = lp["attn"], lp["ffn"]
            layer = {
                "wqkv": fuse([unpack_int4(a[k]) for k in ("wq", "wk", "wv")]),
                "wo": unpack_int4(a["wo"]),
                "w13": fuse([unpack_int4(f["w1"]), unpack_int4(f["w3"])]),
                "w2": unpack_int4(f["w2"]),
                "an": lp["attention_norm"],
                "fn": lp["ffn_norm"],
                "b": (torch.cat([a["bq"], a["bk"], a["bv"]]) if "bq" in a else None),
            }
            self.layers.append(layer)
        self._rope = None

    # -- pieces ------------------------------------------------------------

    def _rope_rows(self, pos: torch.Tensor) -> torch.Tensor:
        n = int(pos.max()) + 1
        if self._rope is None or self._rope.shape[0] < n:
            self._rope = rope_table(max(n, 2 * (0 if self._rope is None else
                                                self._rope.shape[0])),
                                    self.d.head_dim, self.d.rope_theta, pos.device)
        return self._rope[pos]

    def _linear(self, x: torch.Tensor, w, bits: Optional[int]) -> torch.Tensor:
        """bf16 x [n, in] through an unpacked int4 weight: a bf16 product
        over the weight dequantized in f32 and rounded (``bits`` None), or
        W4A``bits``."""
        if bits is None:
            return x @ dense(w).to(BF16)
        return qmatmul(x, w, bits)

    def _qkv(self, L: dict, h: torch.Tensor, bits: Optional[int]):
        d = self.d
        y = self._linear(h, L["wqkv"], bits)
        if L["b"] is not None:
            y = y + L["b"]
        Dq, Dkv = d.n_head * d.head_dim, d.n_kv_head * d.head_dim
        q = y[..., :Dq].unflatten(-1, (d.n_head, d.head_dim))
        k = y[..., Dq:Dq + Dkv].unflatten(-1, (d.n_kv_head, d.head_dim))
        v = y[..., Dq + Dkv:].unflatten(-1, (d.n_kv_head, d.head_dim))
        return q, k, v

    def _ffn(self, L: dict, x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
        h = rms_norm(x, L["fn"], self.d.norm_eps)
        gu = self._linear(h, L["w13"], bits)
        g, u = gu.chunk(2, dim=-1)
        return self._linear(torch.nn.functional.silu(g) * u, L["w2"], bits)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits [n, V] of bf16 hidden states: the head is W4A8 at
        prefill's last row too (one row)."""
        return qmatmul(rms_norm(x, self.norm, self.d.norm_eps), self.head,
                       self.decode_bits).float()

    def control(self, on: bool = True) -> None:
        """One step below every stated precision (cache int8 -> int4,
        decode activations int8 -> int4, prefill activations bf16 -> int8),
        or back to the stated ones."""
        self.kv_bits, self.decode_bits, self.prefill_bits = (4, 4, 8) if on else (8, 8, None)

    def _prefill_attention(self, q, k, v):
        """Causal attention over one prompt: bf16 q [n, H, hd], k/v
        [n, KVH, hd]. Returns bf16 y [n, H*hd] (f32 scores and softmax, the
        normalised probabilities rounded to bf16 before the value sum) and
        per key the summed attention (averaged over each KV head's queries)
        from every query (cum) and from the last OBS_LEN queries (obs)."""
        n = q.shape[0]
        d = self.d
        G = d.n_head // d.n_kv_head
        dev = q.device
        qg = q.float().permute(1, 0, 2).reshape(d.n_kv_head, G, n, d.head_dim)
        kf = k.float().permute(1, 0, 2)[:, None]  # [KVH, 1, n, hd]
        vf = v.float().permute(1, 0, 2)[:, None]
        qpos = torch.arange(n, device=dev)[:, None]
        y = torch.empty((d.n_kv_head, G, n, d.head_dim), dtype=BF16, device=dev)
        cum = torch.zeros((d.n_kv_head, n), device=dev)
        obs = torch.zeros_like(cum)
        for c0 in range(0, n, QUERY_CHUNK):
            c1 = min(n, c0 + QUERY_CHUNK)
            s = (qg[:, :, c0:c1] @ kf[:, :, :c1].transpose(-1, -2)) * (1.0 / math.sqrt(d.head_dim))
            p = torch.softmax(s.masked_fill(torch.arange(c1, device=dev)[None, :] > qpos[c0:c1],
                                            float("-inf")), dim=-1)  # [KVH, G, m, c1]
            y[:, :, c0:c1] = (p.to(BF16).float() @ vf[:, :, :c1]).to(BF16)
            pooled = p.mean(dim=1)  # [KVH, m, c1]
            del s, p
            cum[:, :c1] += pooled.sum(dim=1)
            in_obs = qpos[c0:c1, 0] >= n - OBS_LEN
            if bool(in_obs.any()):
                obs[:, :c1] += pooled[:, in_obs].sum(dim=1)
        y = y.reshape(d.n_head, n, d.head_dim).permute(1, 0, 2).reshape(n, -1)
        return y, cum, obs

    def _compress(self, k, v, cum, obs, n: int) -> dict:
        """One layer's cache after prefill: SnapKV's kept keys in position
        order, quantized, with the heavy-hitter history seeded."""
        d, C = self.d, self.C
        kpos = torch.arange(n, device=k.device)
        cum_mean = cum / (n - kpos).float()
        obs_mean = obs / float(min(n, OBS_LEN))
        if n > C:
            pr = avg_pool(obs_mean)
            keep = (kpos >= n - min(n, OBS_LEN)) | (kpos < self.global_tokens)
            pr = torch.where(keep[None], float("inf"), pr)
            order = torch.sort(pr, dim=-1, descending=True, stable=True).indices
            idx = order[:, :C].sort(dim=-1).values  # [KVH, C]
        else:
            idx = kpos[None].expand(d.n_kv_head, n)
        m = idx.shape[1]
        dev = k.device
        st = {name: torch.zeros((d.n_kv_head, C, d.head_dim), device=dev) for name in ("ku", "vu")}
        st.update({name: torch.ones((d.n_kv_head, C), device=dev)
                   for name in ("ks", "kz", "vs", "vz")})
        st["pos"] = torch.full((d.n_kv_head, C), -1, dtype=torch.long, device=dev)
        st["num"] = torch.zeros((d.n_kv_head, C), device=dev)
        st["denom"] = torch.ones((d.n_kv_head, C), device=dev)
        for name, x in (("k", k), ("v", v)):
            kept = x.permute(1, 0, 2).gather(1, idx[..., None].expand(-1, -1, d.head_dim))
            u, s, z = kv_quant(kept, self.kv_bits)
            st[name + "u"][:, :m], st[name + "s"][:, :m], st[name + "z"][:, :m] = u, s, z
        st["pos"][:, :m] = idx
        st["num"][:, :m] = cum_mean.gather(1, idx)
        return st

    def _decode_attention(self, q, st, spos):
        """One query row per lane against the quantized cache: bf16 q
        [B, KVH, G, hd]; returns (bf16 y [B, KVH, G, hd], probabilities
        averaged over the G queries [B, KVH, C])."""
        G = q.shape[2]
        scale = 1.0 / math.sqrt(self.d.head_dim)
        empty = (spos == -1)[:, :, None, :]
        if self.kv_bits == 8:  # integer dots with the int8 cache
            qf = q.float()
            qq, qs = act_quant(qf, 8)
            ki, vi = st["ku"] - 128.0, st["vu"] - 128.0
            di = qq @ ki.transpose(-1, -2)  # [B, KVH, G, C], exact
            s = (di * qs * st["ks"][:, :, None] + qf.sum(-1, keepdim=True)
                 * st["kz"][:, :, None]) * scale
            p = softmax_rows(s.masked_fill(empty, NEG_INF))
            pq, ps = act_quant(p * st["vs"][:, :, None], 8, floor=1e-30)
            dv = (pq.double() @ vi.double()).float()
            y = dv * ps + (p * st["vz"][:, :, None]).sum(-1, keepdim=True)
        else:  # the cache dequantized to bf16
            half = float(2 ** (self.kv_bits - 1))
            kf, vf = ((st[n + "u"] * st[n + "s"][..., None]
                       + (st[n + "z"] - half * st[n + "s"])[..., None]).to(BF16).float()
                      for n in ("k", "v"))
            p = softmax_rows((q.float() @ kf.transpose(-1, -2) * scale).masked_fill(empty,
                                                                                  NEG_INF))
            y = p.to(BF16).float() @ vf
        return y.to(BF16), p.sum(dim=2) * (1.0 / G)

    # -- the two phases ----------------------------------------------------

    def _checked_rows(self, k: torch.Tensor, v: torch.Tensor):
        """The checked layer's K and V rows as the stated cache holds them
        (quantized and read back), f32."""
        return tuple(kv_value(*kv_quant(t, self.kv_bits), self.kv_bits) for t in (k, v))

    @torch.no_grad()
    def prefill(self, tokens: Sequence[int]):
        """(logits [V] of the first served token, per-layer cache states,
        the checked layer's K and V rows [n, KVH, hd] as the cache holds
        them)."""
        d = self.d
        dev = self.head[0].device
        ids = torch.tensor(list(tokens), dtype=torch.long, device=dev)
        n = ids.shape[0]
        x = self.emb[ids]
        cs = self._rope_rows(torch.arange(n, device=dev))
        bits = self.prefill_bits
        states = []
        for L in self.layers:
            q, k, v = self._qkv(L, rms_norm(x, L["an"], d.norm_eps), bits)
            q, k = rope(q, cs), rope(k, cs)
            if len(states) == self.checked:
                checked = self._checked_rows(k, v)
            y, cum, obs = self._prefill_attention(q, k, v)
            x = x + self._linear(y, L["wo"], bits)
            x = x + self._ffn(L, x, bits)
            states.append(self._compress(k, v, cum, obs, n))
            del q, k, v, y
        return self._logits(x[-1:])[0], states, checked

    @torch.no_grad()
    def decode(self, states: List[dict], tokens: torch.Tensor, pos: torch.Tensor):
        """One step for every lane: tokens [B] at positions pos [B] (long);
        ``states`` are stacked per layer ([B, ...] tensors), updated in place.
        Returns logits [B, V] and the checked layer's new K and V rows
        [B, KVH, hd] as the cache holds them."""
        d = self.d
        B = tokens.shape[0]
        G = d.n_head // d.n_kv_head
        x = self.emb[tokens]  # [B, D] bf16
        cs = self._rope_rows(pos)[:, None]  # [B, 1, hd/2, 2]
        bits = self.decode_bits
        rows = torch.arange(B, device=x.device)[:, None]
        heads = torch.arange(d.n_kv_head, device=x.device)[None, :]
        for li, (L, st) in enumerate(zip(self.layers, states)):
            q, k, v = self._qkv(L, rms_norm(x, L["an"], d.norm_eps), bits)  # [B, heads, hd]
            q, k = rope(q[:, None], cs)[:, 0], rope(k[:, None], cs)[:, 0]
            if li == self.checked:
                checked = self._checked_rows(k, v)
            # heavy-hitter eviction, then insert before attending
            avg = st["num"] / st["denom"].clamp_min(1.0)
            spos = st["pos"]
            protected = (spos < self.global_tokens) | (spos >= pos[:, None, None] - self.recent)
            avg = torch.where(protected, 1.0, avg)
            avg = torch.where(spos == -1, 0.0, avg)
            idx = avg.argmin(dim=-1)  # [B, KVH], the first minimum
            st["num"][rows, heads, idx] = 0.0
            st["denom"][rows, heads, idx] = 0.0
            for name, t in (("k", k), ("v", v)):
                u, s, z = kv_quant(t, self.kv_bits)
                st[name + "u"][rows, heads, idx] = u
                st[name + "s"][rows, heads, idx] = s
                st[name + "z"][rows, heads, idx] = z
            spos[rows, heads, idx] = pos[:, None]
            y, pooled = self._decode_attention(q.view(B, d.n_kv_head, G, d.head_dim), st, spos)
            st["num"] += pooled
            st["denom"] += 1.0
            x = x + self._linear(y.reshape(B, -1), L["wo"], bits)
            x = x + self._ffn(L, x, bits)
        return self._logits(x), checked

    @torch.no_grad()
    def follow(self, prompts: Sequence[Sequence[int]], served: Sequence[Sequence[int]],
               choices: Optional[Sequence[Sequence[int]]] = None) -> dict:
        """Teacher-force each lane's served tokens after its prompt. Returns,
        per lane and served position, ``gap``: how far the chosen token's
        logit lies below the best (the chosen token is the served one, or
        ``choices``: one id per position), ``logp``: the chosen token's log
        probability, and ``top``: the id this reference puts first; ``pos``,
        each layer's cached positions [lanes, KVH, C] at the end; per lane
        ``checked_kv``, the checked layer's K and V rows [positions, KVH, hd]
        of every position fed, as the stated cache holds them, and
        ``checked_cache``, the checked layer's cache after the lane's last
        step (``pos`` [KVH, C], ``k`` and ``v`` [KVH, C, hd]). Prompts
        prefill one at a time; the lanes decode together."""
        choices = served if choices is None else choices
        out = {"gap": [[] for _ in prompts], "logp": [[] for _ in prompts],
               "top": [[] for _ in prompts]}

        def read(b: int, lg: torch.Tensor, pick: torch.Tensor, live):
            best = lg.max(dim=-1)
            chosen = lg.gather(-1, pick[:, None])[:, 0]
            gap = (best.values - chosen).tolist()
            logp = (chosen - torch.logsumexp(lg, dim=-1)).tolist()
            top = best.indices.tolist()
            for i, b_ in enumerate(b):
                if live[i]:
                    out["gap"][b_].append(gap[i])
                    out["logp"][b_].append(logp[i])
                    out["top"][b_].append(top[i])

        dev = self.head[0].device
        per_lane, rows = [], []
        for b, p in enumerate(prompts):
            lg, st, checked = self.prefill(p)
            per_lane.append(st)
            rows.append([[t.cpu()] for t in checked])
            read([b], lg[None], torch.tensor([int(choices[b][0])], device=dev), [True])
        states = [{key: torch.stack([lane[i][key] for lane in per_lane])
                   for key in per_lane[0][i]} for i in range(len(self.layers))]
        del per_lane
        out["checked_cache"] = [None] * len(prompts)

        def keep_checked(i: int) -> None:
            """The checked layer's cache of the lanes whose last step was i."""
            st = states[self.checked]
            for b, s in enumerate(served):
                if len(s) - 2 == i:
                    out["checked_cache"][b] = {
                        "pos": st["pos"][b].cpu(),
                        "k": kv_value(st["ku"][b], st["ks"][b], st["kz"][b], self.kv_bits).cpu(),
                        "v": kv_value(st["vu"][b], st["vs"][b], st["vz"][b], self.kv_bits).cpu()}

        keep_checked(-1)
        lanes = list(range(len(prompts)))
        plens = torch.tensor([len(p) for p in prompts], dtype=torch.long, device=dev)
        for i in range(max(len(s) for s in served) - 1):
            tok = torch.tensor([int(s[i]) if i < len(s) else 0 for s in served],
                               dtype=torch.long, device=dev)
            lg, checked = self.decode(states, tok, plens + i)
            for b, s in enumerate(served):
                if i < len(s) - 1:
                    for j in range(2):
                        rows[b][j].append(checked[j][b:b + 1].cpu())
            keep_checked(i)
            pick = torch.tensor([int(c[i + 1]) if i + 1 < len(c) else 0 for c in choices],
                                dtype=torch.long, device=dev)
            read(lanes, lg, pick, [i + 1 < len(s) for s in served])
        out["pos"] = [st["pos"].cpu() for st in states]
        out["checked_kv"] = [tuple(torch.cat(r) for r in lane) for lane in rows]
        return out
