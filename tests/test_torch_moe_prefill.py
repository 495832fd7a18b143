"""The expert layer's prefill (``ops/moe.py::moe_prefill``): the dispatch
schedule on the card and the grouped int4 GEMM (``csrc/moe_gemm.cu``).

CPU: ``dispatch``'s schedule for ragged counts (an expert with no row, one
row, exactly a tile, a tile and one, every pair on one expert, top 8 of 64):
every pair lands once, each expert's rows keep token order, the tiles cover
each expert's rows in order with the unused slots last; the plain and the
kernel path both run over the one schedule ``dispatch`` gives.

Marked ``cuda`` (they skip, inside a fixture, without a card): the kernels
against ``moe_prefill_plain`` at Mellum2's widths and at ``TestMellum2``'s,
the in-kernel dequantization equal to ``qmm.dequantize_gemv`` to the bit
(through one-hot rows), the combine kernel equal to ``combine`` to the bit,
no synchronisation inside ``moe_prefill``, and three launches a call. On a
machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_prefill.py
"""

import pytest
import torch

from cold_compress_tpu_torch.ops import moe, qmm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _ragged_ids():
    """K = 2 over 6 experts, counts 0, 1, 4, 5, 9, 9: at a tile of 4, expert
    0 has no row, 1 one row, 2 exactly a tile, 3 a tile and one."""
    rows = [(1, 3)] + [(2, 3)] * 4 + [(4, 5)] * 7 + [(5, 4)] * 2
    perm = torch.randperm(len(rows), generator=torch.Generator().manual_seed(0)).tolist()
    return torch.tensor([rows[i] for i in perm], dtype=torch.long), 6, 4


def _edges_at_tile_ids():
    """K = 1 at the kernel's tile: experts with 0, 1, 256 and 257 rows."""
    counts = {1: 1, 2: moe.TILE_ROWS, 3: moe.TILE_ROWS + 1, 4: 300}
    flat = torch.cat([torch.full((n,), e, dtype=torch.long) for e, n in counts.items()])
    perm = torch.randperm(len(flat), generator=torch.Generator().manual_seed(1))
    return flat[perm][:, None], 5, moe.TILE_ROWS


def _one_expert_ids():
    return torch.full((600, 1), 2, dtype=torch.long), 4, moe.TILE_ROWS


def _top8_of_64_ids():
    g = torch.Generator().manual_seed(2)
    return torch.stack([torch.randperm(64, generator=g)[:8] for _ in range(700)]), 64, 256


CASES = {"ragged": _ragged_ids, "edges_at_tile": _edges_at_tile_ids,
         "one_expert": _one_expert_ids, "top8_of_64": _top8_of_64_ids}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_places_every_pair_once_in_token_order(case):
    ids, E, tile = CASES[case]()
    N, K = ids.shape
    sched = moe.dispatch(ids, E, tile)
    flat = ids.reshape(-1)
    pair = sched.pair.long()
    assert sched.pair.dtype == sched.src.dtype == sched.tiles.dtype == torch.int32
    assert sorted(pair.tolist()) == list(range(N * K))
    assert torch.equal(sched.src.long(), pair // K)
    ex = flat[pair]
    assert bool((ex[1:] >= ex[:-1]).all())
    assert bool(((ex[1:] != ex[:-1]) | (pair[1:] > pair[:-1])).all())  # token order
    counts = torch.bincount(flat, minlength=E)
    assert sched.offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_tiles_each_expert_in_order_with_unused_slots_last(case):
    ids, E, tile = CASES[case]()
    N, K = ids.shape
    sched = moe.dispatch(ids, E, tile)
    offsets, tiles = sched.offsets.tolist(), sched.tiles.tolist()
    assert len(tiles) == -(-N * K // tile) + E
    want = [[e, f, min(tile, offsets[e + 1] - f)] for e in range(E)
            for f in range(offsets[e], offsets[e + 1], tile)]
    assert tiles[:len(want)] == want
    assert all(t[2] == 0 and t[1] == N * K for t in tiles[len(want):])


def test_ragged_schedule_has_the_edge_tiles():
    ids, E, tile = _ragged_ids()
    tiles = [t for t in moe.dispatch(ids, E, tile).tiles.tolist() if t[2]]
    assert [(e, rows) for e, _, rows in tiles] == [(1, 1), (2, 4), (3, 4), (3, 1), (4, 4),
                                                  (4, 4), (4, 1), (5, 4), (5, 4), (5, 1)]


def _tiny_experts(E=8, D=256, F=128, gs=128, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)

    def leaf(IN, OUT):
        w = torch.randint(-128, 128, (IN // 2, OUT), dtype=torch.int8, device=device, generator=g)
        s = torch.rand((IN // gs, OUT), device=device, generator=g) * 3e-3 + 1e-3
        z = s * torch.rand((IN // gs, OUT), device=device, generator=g)
        return {"w": w, "scales": s.to(torch.bfloat16), "zeros": z.to(torch.bfloat16),
                "group_size": gs}

    return moe.MoEWeights.from_experts([{"w1": leaf(D, F), "w3": leaf(D, F), "w2": leaf(F, D)}
                                        for _ in range(E)])


def _route(N, E, K, D, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((N, D), device=device, generator=g).to(torch.bfloat16)
    ids = torch.topk(torch.rand((N, E), device=device, generator=g), K, dim=-1).indices
    wts = torch.softmax(torch.randn((N, K), device=device, generator=g), -1)
    return x, ids, wts


def _spy_dispatch(monkeypatch):
    seen = []
    real = moe.dispatch

    def spy(ids, n_experts, *args):
        seen.append(real(ids, n_experts, *args))
        return seen[-1]

    monkeypatch.setattr(moe, "dispatch", spy)
    return seen


def test_plain_path_runs_over_the_dispatch_schedule(monkeypatch):
    mw = _tiny_experts()
    x, ids, wts = _route(40, 8, 4, 256, 3)
    seen = _spy_dispatch(monkeypatch)
    used, real = [], moe.moe_gemm_plain

    def gemm(x, rowmap, tiles, *args, swiglu):
        used.append((rowmap, tiles))
        return real(x, rowmap, tiles, *args, swiglu=swiglu)

    monkeypatch.setattr(moe, "moe_gemm_plain", gemm)
    before = dict(moe.LAUNCHES)
    y = moe.moe_prefill(x, ids, wts, mw)
    (sched,) = seen
    assert used == [(sched.src, sched.tiles), (sched.pair, sched.tiles)]
    assert y.shape == (40, 256) and y.dtype == torch.bfloat16
    assert moe.LAUNCHES == before  # no kernel counted on the CPU


def test_kernel_path_launches_over_the_same_schedule(monkeypatch):
    """The kernel path (driven on meta tensors, its launches recorded) takes
    ``dispatch``'s one schedule: gate and up over ``src``, down over
    ``pair``, both over its tiles, then the combine."""
    meta = torch.device("meta")
    mw = moe.MoEWeights(*(t.to(meta) for t in _tiny_experts().tensors()), 128, 128)
    N, K = 40, 4
    x = torch.empty((N, 256), dtype=torch.bfloat16, device=meta)
    ids = torch.empty((N, K), dtype=torch.long, device=meta)
    wts = torch.empty((N, K), dtype=torch.float32, device=meta)
    seen = _spy_dispatch(monkeypatch)
    launched = []
    monkeypatch.setattr(moe, "moe_gemm", lambda x, rowmap, tiles, w, sz, gs, out, swiglu:
                        launched.append((rowmap, tiles, w, swiglu, tuple(out.shape))))
    monkeypatch.setattr(moe, "moe_combine", lambda y, w: launched.append(tuple(y.shape)) or
                        torch.empty((y.shape[0], y.shape[2]), dtype=torch.bfloat16, device=meta))
    y = moe.moe_prefill(x, ids, wts, mw)
    (sched,) = seen
    assert launched == [(sched.src, sched.tiles, mw.w13, True, (N * K, 128)),
                        (sched.pair, sched.tiles, mw.w2, False, (N * K, 256)), (N, K, 256)]
    assert y.shape == (N, 256)


def test_kernel_path_refuses_widths_it_does_not_take():
    meta = torch.device("meta")
    mw = moe.MoEWeights(*(t.to(meta) for t in _tiny_experts(D=192, gs=32).tensors()), 32, 32)
    x = torch.empty((4, 192), dtype=torch.bfloat16, device=meta)
    ids = torch.empty((4, 2), dtype=torch.long, device=meta)
    with pytest.raises(ValueError, match="widths"):
        moe.moe_prefill(x, ids, torch.empty((4, 2), device=meta), mw)


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


MELLUM2 = dict(E=64, K=8, D=2304, F=896)
TINY = dict(E=8, K=4, D=256, F=128)


def _assert_close(y, ref):
    """Element by element: one bf16 unit where the sides round apart, plus
    2**-8 of the row's largest. Only the order of each f32 sum differs (the
    kernel's wgmma against cuBLAS): a gate or up product may round one bf16
    unit apart before SwiGLU, and the down product over F inputs carries
    that h unit as a fraction of one term."""
    r = ref.float().abs()
    tol = 2**-7 * r + 2**-8 * r.amax(-1, keepdim=True)
    err = (y.float() - ref.float()).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,N", [("mellum2", 4 * 1000 + 3), ("mellum2", 5), ("tiny", 300),
                                     ("tiny", 1)])
def test_prefill_kernels_match_plain(dev, shape, N):
    w = MELLUM2 if shape == "mellum2" else TINY
    mw = _tiny_experts(w["E"], w["D"], w["F"], 128, seed=N, device=dev)
    x, ids, wts = _route(N, w["E"], w["K"], w["D"], N + 1, device=dev)
    before = dict(moe.LAUNCHES)
    y = moe.moe_prefill(x, ids, wts, mw)
    assert {k: moe.LAUNCHES[k] - before[k] for k in ("moe_gemm.w13", "moe_gemm.w2",
                                                      "moe_combine")} == {
        "moe_gemm.w13": 1, "moe_gemm.w2": 1, "moe_combine": 1}
    _assert_close(y, moe.moe_prefill_plain(x, ids, wts, mw))
    assert torch.equal(y, moe.moe_prefill(x, ids, wts, mw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["mellum2", "tiny"])
def test_in_kernel_dequantization_is_dequantize_gemv_to_the_bit(dev, shape):
    """One-hot bf16 rows, each expert's every input once: each product is a
    single weight times one, so the down launch writes the dequantized
    weight itself and the gate/up launch SwiGLU of the dequantized gate and
    up weights, both to the bit."""
    w = MELLUM2 if shape == "mellum2" else TINY
    E, D, F = w["E"], w["D"], w["F"]
    mw = _tiny_experts(E, D, F, 128, seed=7, device=dev)
    for IN, OUT, wt, sz, gs, swiglu in ((D, 2 * F, mw.w13, mw.sz13, mw.gs13, True),
                                        (F, D, mw.w2, mw.sz2, mw.gs2, False)):
        ids = torch.arange(E, device=dev).repeat_interleave(IN)[:, None]
        sched = moe.dispatch(ids, E)
        x = torch.eye(IN, dtype=torch.bfloat16, device=dev).repeat(E, 1)
        out = torch.full((E * IN, OUT // 2 if swiglu else OUT), float("nan"),
                         dtype=torch.bfloat16, device=dev)
        moe.moe_gemm(x, sched.src if swiglu else sched.pair, sched.tiles, wt, sz, gs, out,
                     swiglu=swiglu)
        dense = qmm.dequantize_gemv(wt, sz, gs).reshape(E * IN, OUT)
        want = moe.swiglu_pairs(dense) if swiglu else dense
        assert torch.equal(out, want), shape


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,D", [(4 * 1000, 8, 2304), (37, 4, 256)])
def test_combine_kernel_is_combine_to_the_bit(dev, N, K, D):
    g = torch.Generator(device=dev).manual_seed(N)
    y = torch.randn((N, K, D), device=dev, generator=g).to(torch.bfloat16)
    wts = torch.softmax(torch.randn((N, K), device=dev, generator=g), -1)
    assert torch.equal(moe.moe_combine(y, wts), moe.combine(y, wts))


@pytest.mark.cuda
def test_prefill_makes_no_host_read(dev):
    w = MELLUM2
    mw = _tiny_experts(w["E"], w["D"], w["F"], 128, seed=11, device=dev)
    x, ids, wts = _route(2048, w["E"], w["K"], w["D"], 12, device=dev)
    ref = moe.moe_prefill(x, ids, wts, mw)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.moe_prefill(x, ids, wts, mw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y, ref)
