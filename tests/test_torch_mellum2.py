"""Mellum2's architecture in the port: experts, sliding-window layers and
YaRN, held to the benchmark's plain reference (``portbench/reference/
mellum2.py``, plain torch that imports nothing of the port).

CPU: the tiny Mellum2 (``TestMellum2``: one period of three sliding layers
of a 128-token window and a full layer, 8 experts top 4, YaRN over 32
original positions) through ``prefill`` and 8 decode steps against the
reference, teacher-forced with the reference's greedy tokens; five faults
that must fail that comparison; the distinct-experts counter against the
reference's routing; the pieces (YaRN's table, the cache specs, the ring's
layout and insert, the windowed attention, the CLIs).

Marked ``cuda`` (they skip, inside a fixture, without a card): the grouped
expert GEMV against its plain version at Mellum2's widths, K4's window
against its plain version at 16384 rows, the ring's fused insert against
its plain version, and the tiny model's captured graph against eager decode.
On a machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_mellum2.py
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cold_compress_tpu_torch import ops
from cold_compress_tpu_torch.caches import get_cache_strategy, init_state
from cold_compress_tpu_torch.caches.base import CacheSpec
from cold_compress_tpu_torch.models import transformer
from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.models.rope import precompute_freqs_cis
from cold_compress_tpu_torch.ops import evict, moe, prefill_attn
from cold_compress_tpu_torch.ops.attention import chunked_prefill_partial, gqa_attention
from cold_compress_tpu_torch.quantization.weight_quant import random_quantized_params
from cold_compress_tpu_torch.runtime import engine
from portbench.reference import mellum2 as ref_mellum2
from portbench.tests import tiny_mellum2
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]

#: The comparison's tolerance: the RMS of the logit gap over every position
#: and vocabulary entry, relative to the logits' RMS. On the CPU the
#: program's plain versions and the reference round at the same places and
#: sum in the same order, so they agree to the bit (the sound run reads 0);
#: the room, half a bf16 unit (2**-9), is for a summation order that
#: differs, which moves an activation by its last place now and then, far
#: less than a unit over all the logits. The five faults below read 1.1e-2
#: (default rope on the full layer: YaRN moves only the slow frequencies and
#: the scores' scale) to 8e-2 (no window at prefill): each changes whole
#: attention rows or expert outputs, not roundings.
LOGIT_TOL = 2.0**-9

PROMPT_LENS = (200, 150)
STEPS = 8


def tiny_cell():
    return tiny_mellum2.cell()


def reference(seed: int = 0):
    cell = tiny_cell()
    arch, d = cell.arch, cell.dims
    return arch.Reference(d, arch.make_weights(d, seed, "cpu"), cell.traffic["cache"],
                          checked=arch.checked_layer(d))


def prompts(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(5, 500, (n,), generator=g).tolist() for n in PROMPT_LENS]


def reference_run(ref, lanes):
    """Per lane, the reference's logits at prefill and at STEPS decode steps
    fed its own greedy tokens: ([B, STEPS + 1, V] f32, fed tokens)."""
    logits, fed, states = [], [], []
    for p in lanes:
        lg, st, _ = ref.prefill(p)
        logits.append([lg])
        states.append(st)
    states = [{k: torch.stack([lane[i][k] for lane in states]) for k in states[0][i]}
              for i in range(len(ref.layers))]
    tok = torch.stack([lane[0].argmax() for lane in logits])
    pos = torch.tensor([len(p) for p in lanes])
    for i in range(STEPS):
        fed.append(tok)
        lg, _ = ref.decode(states, tok, pos + i)
        for b in range(len(lanes)):
            logits[b].append(lg[b])
        tok = lg.argmax(-1)
    return torch.stack([torch.stack(lane) for lane in logits]), fed


def program_run(lanes, fed, cfg=None, specs=None, seed: int = 0, i8dot=True):
    """The program's logits over the same lanes and fed tokens: ``prefill``
    of the padded prompts, then ``decode_step`` per step (the plain
    versions, on the CPU)."""
    cell = tiny_cell()
    arch, d = cell.arch, cell.dims
    cfg = cfg or arch.port_config(cell)
    model = engine.build_model(cfg, arch.make_weights(d, seed, "cpu"), "cpu",
                               max_positions=256, attn_i8dot=i8dot)
    if specs is None:
        specs = engine.build_cache_specs(cfg, arch.cache_kwargs(cell.traffic["cache"], cfg), 256)
    caches = transformer.init_caches(cfg, specs, len(lanes), device="cpu")
    P = 256
    toks = torch.zeros((len(lanes), P), dtype=torch.long)
    for b, p in enumerate(lanes):
        toks[b, :len(p)] = torch.tensor(p)
    plen = torch.tensor([len(p) for p in lanes], dtype=torch.int32)
    out = []
    with torch.no_grad():
        out.append(transformer.prefill(model, caches, toks, plen))
        for i, tok in enumerate(fed):
            out.append(transformer.decode_step(model, caches, tok, plen + i))
    return torch.stack(out, dim=1), model, caches


def gap(a, b) -> float:
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.fixture(scope="module")
def sound():
    ref = reference()
    lanes = prompts()
    want, fed = reference_run(ref, lanes)
    return lanes, want, fed


def test_tiny_mellum2_prefill_and_decode_match_the_reference(sound):
    lanes, want, fed = sound
    got, _, caches = program_run(lanes, fed)
    assert gap(got, want) <= LOGIT_TOL
    assert gap(got, want) == 0.0  # the plain versions round as the reference does
    # the positions fed span the window and YaRN's original length
    assert min(PROMPT_LENS) > 128 > 32
    # the full layer held every position (nothing evicted there hides a
    # fault); each sliding layer holds its window
    assert caches[3].cache_ct[:, 0].tolist() == [n + STEPS for n in PROMPT_LENS]
    assert all((c.cache_ct == 128).all() for c in caches[:3])


def sliding_prefill_without_bound(monkeypatch):
    real = transformer.prefill_attention
    monkeypatch.setattr(transformer, "prefill_attention",
                        lambda *a, window=0, **kw: real(*a, **kw))


FAULTS = {
    "default rope on the full layers": lambda mp, cfg: (cfg.replace(rope_scaling=None), None),
    "no left window bound in prefill": lambda mp, cfg: (sliding_prefill_without_bound(mp)
                                                       or cfg, None),
    "a ring one slot longer than the window": lambda mp, cfg: (cfg, tuple(
        CacheSpec(**{**s.__dict__, "max_cache_length": s.max_cache_length + 1})
        if s.cache_strategy == "window" else s
        for s in engine.build_cache_specs(cfg, tiny_cell().arch.cache_kwargs(
            tiny_cell().traffic["cache"], cfg), 256))),
    "routing without renormalisation": lambda mp, cfg: (cfg.replace(norm_topk_prob=False), None),
    "one expert fewer (top-3 of top-4, Mellum2's top-7)":
        lambda mp, cfg: (cfg.replace(n_experts_per_tok=3), None),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_fails_the_comparison(sound, fault, monkeypatch):
    lanes, want, fed = sound
    cell = tiny_cell()
    cfg, specs = FAULTS[fault](monkeypatch, cell.arch.port_config(cell))
    got, _, _ = program_run(lanes, fed, cfg=cfg, specs=specs)
    assert gap(got, want) > 4 * LOGIT_TOL, gap(got, want)


def test_distinct_expert_counter_matches_the_reference_routing(sound, monkeypatch):
    """The counter adds each step's distinct experts per layer over both
    lanes: the reference's routing of the same steps gives the same."""
    lanes, _, fed = sound
    ref = reference()
    picked = {}
    real_route = ref_mellum2.Reference._route

    def route(self, L, h):
        ids, w = real_route(self, L, h)
        if h.shape[0] == len(lanes):  # a decode step (prefill routes a whole prompt)
            li = next(i for i, x in enumerate(self.layers) if x is L)
            picked.setdefault(li, []).append(len(set(ids.reshape(-1).tolist())))
        return ids, w

    monkeypatch.setattr(ref_mellum2.Reference, "_route", route)
    reference_run(ref, lanes)
    before = ops.kernel_launches()
    program_run(lanes, fed)
    after = ops.kernel_launches()
    for li, counts in picked.items():
        key = f"moe_gemv.experts.{li}"
        assert after.get(key, 0) - before.get(key, 0) == sum(counts)
    assert len(picked) == 4 and all(len(c) == STEPS for c in picked.values())
    # two lanes of top 4 among 8 experts: some steps share experts
    assert any(c < 8 for counts in picked.values() for c in counts)


def test_yarn_table_matches_the_reference_and_the_published_dims():
    cfg = ModelConfig.from_name("Mellum2-12B-A2.5B")
    got = precompute_freqs_cis(9000, 128, cfg.rope_base, cfg.rope_scaling)
    want = ref_mellum2.rope_table(9000, 128, 5e5, (16.0, 8192, 32.0, 1.0, 1.2772588722239782),
                                  "cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=2e-7)
    # the ramp's ends: dims 18 (beta 32, floored) and 35 (beta 1, ceiled)
    lo = 128 * math.log(8192 / (32 * 2 * math.pi)) / (2 * math.log(5e5))
    hi = 128 * math.log(8192 / (2 * math.pi)) / (2 * math.log(5e5))
    assert (math.floor(lo), math.ceil(hi)) == (18, 35)
    plain = precompute_freqs_cis(9000, 128, cfg.rope_base, None)
    # below the ramp the frequencies are the default's, above it /16; cos, sin
    # carry the attention factor
    assert torch.allclose(got[1, :18], plain[1, :18] * 1.2772588722239782, atol=1e-6)
    inv = 1.0 / 5e5 ** (torch.arange(0, 128, 2, dtype=torch.float64) / 128)
    assert torch.allclose(got[8999, 40, 1].double(), torch.sin(8999 * inv[40] / 16) * 1.2772588722239782,
                          atol=1e-5)


def test_registry_and_cache_specs_give_the_sliding_layers_their_ring():
    cfg = ModelConfig.from_name("Mellum2-12B-A2.5B")
    assert (cfg.head_dim, cfg.dim // cfg.n_head) == (128, 72)
    assert sum(map(cfg.is_sliding, range(28))) == 21 and not cfg.is_sliding(3)
    assert all(map(cfg.is_moe, range(28)))
    kw = {"cache_strategy": ["heavy_hitter"], "max_cache_length": [2048],
          "prompt_compression_strategy": ["heavy_hitter"], "global_tokens": 4,
          "recent_window": 10, "cache_bits": 8}
    specs = engine.build_cache_specs(cfg, kw, 16384)
    for i, s in enumerate(specs):
        if cfg.is_sliding(i):
            assert (s.cache_strategy, s.max_cache_length, s.global_tokens, s.cache_bits,
                    s.prompt_compression_strategy) == ("window", 1024, 0, 8, "recent_global")
        else:
            assert (s.cache_strategy, s.max_cache_length) == ("heavy_hitter", 2048)
    assert engine.min_cache_length(specs) == 2048
    # a dense model's specs are as before
    dense = engine.build_cache_specs(ModelConfig.from_name("TestKernel"), kw, 512)
    assert {s.cache_strategy for s in dense} == {"heavy_hitter"}


@pytest.mark.parametrize("n", [40, 100, 128, 301])
def test_ring_holds_the_window_at_position_mod_w(n):
    """After a prefill of n tokens and 5 steps the ring holds exactly the
    last W positions, position p at slot p mod W; the fused insert's plain
    version (kv8, heads of 128) and the eager insert (heads of 64) agree."""
    W = 128
    rows = {}
    for hd in (128, 64):
        spec = CacheSpec(cache_strategy="window", max_cache_length=W, max_seq_length=512,
                         global_tokens=0, recent_window=W, cache_bits=8,
                         prompt_compression_strategy="recent_global")
        st = get_cache_strategy("window").init(spec, 1, 1, hd, device="cpu")
        P = 512 if n > 256 else 256
        g = torch.Generator().manual_seed(n)
        k = torch.randn((1, 1, P, hd), generator=g).to(torch.bfloat16)
        v = torch.randn((1, 1, P, hd), generator=g).to(torch.bfloat16)
        valid = (torch.arange(P) < n)[None]
        transformer.fill_from_kv(get_cache_strategy("window"),
                                 transformer.get_prompt_compressor("recent_global"), st, k, v,
                                 None, torch.arange(P, dtype=torch.int32), valid, n)
        freqs = precompute_freqs_cis(512, hd, 10000.0)
        for step in range(5):
            y = torch.randn((1, 1, 3 * hd), generator=g).to(torch.bfloat16)
            qkv = transformer.QKVRows(y, freqs[n + step][None, None], 1, 1, hd)
            transformer.decode_update(get_cache_strategy("window"), st,
                                      torch.tensor([n + step], dtype=torch.int32), qkv, None)
        pos = st.pos[0, 0]
        held = sorted(p for p in pos.tolist() if p >= 0)
        assert held == list(range(max(0, n + 5 - W), n + 5))
        for s, p in enumerate(pos.tolist()):
            assert p == -1 or p % W == s
        assert int(st.cache_ct) == len(held)
        rows[hd] = pos
    assert torch.equal(rows[128], rows[64])


@pytest.mark.parametrize("P,window", [(64, 16), (256, 100), (300, 64)])
def test_windowed_prefill_attention_is_the_masked_softmax(P, window):
    g = torch.Generator().manual_seed(P + window)
    q = torch.randn((1, 4, P, 32), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 2, P, 32), generator=g).to(torch.bfloat16)
    v = torch.randn((1, 2, P, 32), generator=g).to(torch.bfloat16)
    y, _, _ = chunked_prefill_partial(q, k, v, P, chunk_size=64, window=window)
    i, j = torch.arange(P)[:, None], torch.arange(P)[None, :]
    mask = (j <= i) & (j > i - window)
    want, _ = gqa_attention(q.float(), k.float(), v.float(), mask=mask[None, None, None])
    torch.testing.assert_close(y.float(), want, rtol=0, atol=2e-2)
    wide, _, _ = chunked_prefill_partial(q, k, v, P, chunk_size=64)
    assert not torch.allclose(y, wide)  # the bound changes the rows past the window
    with pytest.raises(ValueError, match="no attention summary"):
        transformer.prefill_attention(q, k, v, torch.ones((1, P), dtype=torch.bool), P,
                                      need_summary=True, window=window)


def test_dequantize_gemv_takes_a_stack_of_experts():
    """The prefill dequantizes a layer's stacked experts [E, OUT, IN/2] in
    one call; each expert's slice is the 2-D call's result on its own."""
    from cold_compress_tpu_torch.ops import qmm

    g = torch.Generator().manual_seed(3)
    E, OUT, IN, gs = 3, 8, 256, 128
    w = torch.randint(0, 256, (E, OUT, IN // 2), dtype=torch.uint8, generator=g)
    sz = (torch.rand((E, OUT, IN // gs, 2), generator=g) * 1e-2).to(torch.bfloat16)
    stacked = qmm.dequantize_gemv(w, sz, gs)
    assert stacked.shape == (E, IN, OUT)
    for e in range(E):
        assert torch.equal(stacked[e], qmm.dequantize_gemv(w[e], sz[e], gs))


def test_prefill_experts_match_their_decode_function():
    """The prefill's bf16 experts and the decode's W4A8 experts compute one
    layer: over the same rows they agree to the activations' int8 rounding;
    the counter sees only decode."""
    cfg = ModelConfig.from_name("TestMellum2")
    params = engine.params_from_flat(random_quantized_params(cfg, seed=3), "cpu")
    m = transformer.MoE(params["layers"][0]["moe"], 0, 4, True)
    x = (torch.randn((6, 256), generator=torch.Generator().manual_seed(1))).to(torch.bfloat16)
    ids, wts = transformer.route(m, x)
    before = moe.expert_counter("cpu")[0].item()
    pre = moe.moe_prefill(x, ids, wts, m.weights())
    assert moe.expert_counter("cpu")[0].item() == before
    dec = moe.moe_decode(x, ids, wts, m.weights(), layer=0, arrive=m.arrive)
    assert moe.expert_counter("cpu")[0].item() == before + len(set(ids.reshape(-1).tolist()))
    assert float((pre.float() - dec.float()).abs().max()) <= 0.05 * float(pre.abs().max())
    assert torch.allclose(wts.sum(-1), torch.ones(6))


@pytest.mark.parametrize("cli", ["generate", "eval"])
def test_clis_run_the_tiny_mellum2(cli, tmp_path):
    """The generate and eval CLIs build the expert model through the normal
    path (``build_model``, ``build_cache_specs``, ``init_caches``,
    ``generate``/``generate_batch``) from the registry name."""
    if cli == "generate":
        args = ["--random_weights", "TestMellum2", "--prompt", "def f(x):" * 20,
                "--max_new_tokens", "6", "--cache_strategy", "heavy_hitter",
                "--prompt_compression_strategy", "heavy_hitter", "--max_cache_length", "0.5",
                "--cache_bits", "8"]
    else:
        args = ["--random_weights", "TestMellum2", "--random_quantize", "int4", "--tasks",
                "rulerniah", "--num_samples", "2", "--batch_size", "2",
                "--ruler_context_sentences", "20", "--cache_strategy", "heavy_hitter",
                "--prompt_compression_strategy", "heavy_hitter", "--max_cache_length", "0.5",
                "--cache_bits", "8", "--out_dir", str(tmp_path)]
    p = subprocess.run([sys.executable, "-m", f"cold_compress_tpu_torch.{cli}", "--device",
                        "cpu", *args], cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-3000:]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _experts(dev, seed, E=64, D=2304, F=896, gs=128):
    g = torch.Generator(device=dev).manual_seed(seed)

    def leaf(IN, OUT):
        w = torch.randint(-128, 128, (IN // 2, OUT), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((IN // gs, OUT), device=dev, generator=g) * 3e-3 + 1e-3)
        z = s * torch.rand((IN // gs, OUT), device=dev, generator=g)
        return {"w": w, "scales": s.to(torch.bfloat16), "zeros": z.to(torch.bfloat16),
                "group_size": gs}

    return moe.MoEWeights.from_experts([{"w1": leaf(D, F), "w3": leaf(D, F), "w2": leaf(F, D)}
                                        for _ in range(E)])


def _assert_bf16_close(y, ref, row_share):
    """Element by element: one bf16 unit where the sides round apart, plus
    ``row_share`` of the row's largest element for what the f32 sums'
    order and the intermediate bf16 roundings move."""
    r = ref.float().abs()
    tol = 2**-7 * r + row_share * r.amax(-1, keepdim=True)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 16])
def test_grouped_expert_gemv_matches_plain(dev, B):
    """Mellum2's widths, 64 experts, top 8; at B > 1 every later lane shares
    three of lane 0's experts (at B = 16 the two launches' groups of 8 lanes
    both read them). The kernels read each distinct expert once per group
    (the counter), combine in k order and give the same bits twice."""
    mw = _experts(dev, B)
    g = torch.Generator(device=dev).manual_seed(10 + B)
    x = torch.randn((B, 2304), device=dev, generator=g).to(torch.bfloat16)
    # Each lane's 8 experts distinct, as top k gives them (the kernel holds
    # at most 8 rows of one expert, so a group's lanes must not repeat one):
    # every later lane takes lane 0's first three, lane 2 also lane 1's last.
    lanes = [torch.randperm(64, device=dev, generator=g)[:8].tolist()]
    for b in range(1, B):
        shared = lanes[0][:3] + ([lanes[1][7]] if b == 2 else [])
        rest = [e for e in torch.randperm(64, device=dev, generator=g).tolist()
                if e not in shared]
        lanes.append(shared + rest[:8 - len(shared)])
    ids = torch.tensor(lanes, dtype=torch.long, device=dev)
    wts = torch.softmax(torch.randn((B, 8), device=dev, generator=g), -1)
    arrive = moe.arrive_buffer(2304, dev)
    layer = 7
    c0 = int(moe.expert_counter(dev)[layer])
    y = moe.moe_decode(x, ids, wts, mw, layer=layer, arrive=arrive)
    groups = range(0, B, moe.MAX_LANES)
    assert int(moe.expert_counter(dev)[layer]) - c0 == sum(
        len(set(ids[g:g + moe.MAX_LANES].reshape(-1).tolist())) for g in groups)
    ref = moe.moe_decode_plain(x, ids, wts, mw)
    # The gate and up results round to bf16 before SwiGLU on both sides:
    # where f32 order rounds one apart, h moves by a bf16 unit, and the down
    # product over 896 inputs carries ~2**-8 of a term; 2**-6 of the row.
    _assert_bf16_close(y, ref, 2**-6)
    assert torch.equal(y, moe.moe_decode(x, ids, wts, mw, layer=layer, arrive=arrive))
    assert int(arrive.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("P,plen,window,G,KVH", [(16384, 16256, 1024, 8, 4),
                                                 (1024, 1000, 100, 8, 1), (512, 512, 64, 2, 2)])
def test_flash_prefill_window_matches_plain(dev, P, plen, window, G, KVH):
    g = torch.Generator(device=dev).manual_seed(P + window)
    q = torch.randn((1, KVH * G, P, 128), device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn((1, KVH, P, 128), device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn((1, KVH, P, 128), device=dev, generator=g).to(torch.bfloat16)
    before = prefill_attn.LAUNCHES["flash_prefill_window"]
    y = prefill_attn.flash_prefill_window(q, k, v, window)
    assert prefill_attn.LAUNCHES["flash_prefill_window"] == before + 1
    ref, _, _ = chunked_prefill_partial(q, k, v, plen, window=window)
    # K4's bf16 rounding of the unnormalised probabilities per tile against
    # the plain version's normalised ones (as for the causal kernel).
    _assert_bf16_close(y[:, :, :plen], ref[:, :, :plen], 2**-7)
    assert torch.equal(y, prefill_attn.flash_prefill_window(q, k, v, window))


@pytest.mark.cuda
def test_ring_insert_kernel_matches_plain(dev):
    """The fused insert into a 1024-slot ring (Mellum2's window, 4 KV heads
    of 8 queries, 4 lanes) against its plain version, step by step: q, the
    slot and every cache tensor the same bits."""
    B, KVH, G, W = 4, 4, 8, 1024
    spec = CacheSpec(cache_strategy="window", max_cache_length=W, max_seq_length=4096,
                     global_tokens=0, recent_window=W, cache_bits=8,
                     prompt_compression_strategy="recent_global")
    card = init_state(spec, B, KVH, 128, device=dev)
    cpu = init_state(spec, B, KVH, 128, device="cpu")
    freqs = precompute_freqs_cis(4096, 128, 5e5, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    pos = torch.tensor([1000, 1023, 2047, 3000], dtype=torch.int32, device=dev)
    for step in range(6):
        y = torch.randn((B, 1, (G + 2) * KVH * 128), device=dev, generator=g).to(torch.bfloat16)
        f = freqs[(pos + step).long()][:, None]
        before = evict.LAUNCHES["hh_evict_insert.window"]
        q, idx = evict.hh_evict_insert(y, f, card, pos + step, n_head=KVH * G, n_kv_head=KVH,
                                       window=W)
        assert evict.LAUNCHES["hh_evict_insert.window"] == before + 1
        qp, ip = evict.hh_evict_insert_plain(y.cpu(), f.cpu(), cpu, (pos + step).cpu(),
                                             KVH * G, KVH, window=W)
        assert torch.equal(q.cpu(), qp) and torch.equal(idx.cpu(), ip)
        assert idx[:, 0].tolist() == [(p + step) % W for p in pos.tolist()]
    for a, b in zip(card.tensors(), cpu.tensors()):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_tiny_mellum2_graph_matches_eager_on_card(dev):
    """The tiny Mellum2 on the card: the captured decode graph (experts'
    launches, the ring's inserts, both rope tables) gives the eager step's
    tokens and probabilities, and each replay counts 2 expert launches a
    layer."""
    from cold_compress_tpu_torch.runtime import generate as gen

    cell = tiny_cell()
    arch, d = cell.arch, cell.dims
    cfg = arch.port_config(cell)
    model = engine.build_model(cfg, arch.make_weights(d, 0, dev), dev, max_positions=256)
    specs = engine.build_cache_specs(cfg, arch.cache_kwargs(cell.traffic["cache"], cfg), 256)
    caches = transformer.init_caches(cfg, specs, 2, device=dev)
    lanes = prompts()
    out = {}
    for graph in (False, True, True):
        gen.reset_caches(caches)
        seqs, info, _ = gen.generate_batch(model, caches, lanes, 10, cuda_graph=graph)
        out.setdefault(graph, []).append((seqs, info["emitted_probs"]))
    assert out[False][0] == out[True][0] == out[True][1]
    launches = info["decode_graph"]["launches_per_replay"]
    assert launches["moe_gemv.w13"] == launches["moe_gemv.w2"] == 4
    assert launches["hh_evict_insert.window"] == 3 and launches["hh_evict_insert"] == 1
