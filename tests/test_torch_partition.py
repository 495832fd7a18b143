"""How the kernels' wrappers cut their work: decode attention's cluster of
CTAs over the cache slots (K3/K5), the prefill pass 2's work items of one
128-key block against one segment of query rows (K4/K6), the W4A8 and W8A8
decode matmuls' column tiles (K1/K2/K10, K9), and the W4A8 prefill matmul's
persistent tile schedule (K8). Pure Python, so it runs
here; the kernels compute their ranges with the same formulas."""

import math

import pytest

from cold_compress_tpu_torch.ops import decode_attn, prefill_attn, qmm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("C", [1, 2, 127, 128, 129, 300, 1024, 1025, 2048, 2049, 4093,
                               8192, 32768, 131072])
@pytest.mark.parametrize("cap", [16, 8])
def test_cluster_covers_every_slot_once(C, cap):
    nc = decode_attn.cluster_size(C, cap)
    assert 1 <= nc <= cap and nc == min(cap, -(-C // 128))
    ranges = decode_attn.cta_ranges(C, nc)
    assert len(ranges) == nc
    covered = [c for b, e in ranges for c in range(b, e)]
    assert covered == list(range(C))
    per = -(-C // nc)
    assert all(0 < e - b <= per for b, e in ranges)  # no CTA idle, none over its share


@pytest.mark.parametrize("C,G,nc,fits", [
    (32768, 4, 16, True), (32768, 8, 16, True), (32768, 4, 9, True), (49152, 8, 16, False),
    (131072, 8, 16, False), (131072, 4, 16, False), (4096, 8, 1, False), (4096, 8, 8, True),
])
def test_scores_fit_in_shared_memory(C, G, nc, fits):
    assert decode_attn.scores_in_smem(C, G, nc) == fits


@pytest.mark.parametrize("P,G,plen", [
    (64, 2, 50), (64, 8, 64), (1024, 2, 1000), (1024, 8, 77), (8192, 4, 7928),
    (8192, 2, 8192), (32768, 4, 32504), (256, 4, 0),
])
def test_colsum_items_cover_every_valid_row_once(P, G, plen):
    """For every key block, its items' row ranges tile the rows that can
    see it ([128 kb G, plen G)) without overlap, each within one segment."""
    seg_rows, n_seg = prefill_attn.colsum_segments(P, G)
    assert seg_rows % 64 == 0 and n_seg <= prefill_attn.MAX_SEGMENTS
    assert n_seg * seg_rows >= P * G
    items = prefill_attn.colsum_items(P, G, plen)
    by_kb = {}
    for kb, s, r0, r1 in items:
        assert s * seg_rows <= r0 < r1 <= (s + 1) * seg_rows
        by_kb.setdefault(kb, []).append((s, r0, r1))
    for kb in range(-(-P // prefill_attn.KEYS_PER_ITEM)):
        want_begin, want_end = kb * prefill_attn.KEYS_PER_ITEM * G, min(plen, P) * G
        spans = sorted(by_kb.get(kb, []))
        if want_begin >= want_end:
            assert not spans
            continue
        assert spans[0][1] == want_begin and spans[-1][2] == want_end
        assert all(a[2] == b[1] and a[0] + 1 == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("P,G,plen", [(8192, 4, 7928), (32768, 4, 32504), (8192, 8, 8192),
                                      (2048, 4, 1900)])
def test_colsum_items_are_balanced(P, G, plen):
    """No item carries more than twice the mean work, where the previous
    design gave key block 0 all P * G rows (512 times the last block)."""
    rows = [r1 - r0 for _, _, r0, r1 in prefill_attn.colsum_items(P, G, plen)]
    mean = sum(rows) / len(rows)
    assert max(rows) <= 2 * mean


@pytest.mark.parametrize("P,bytes_", [(8192, 16 * 2**20), (32768, 64 * 2**20)])
def test_colsum_workspace_bytes(P, bytes_):
    """K4's per-segment partials [2, n_seg, B, KVH, P] f32 at the 8B shapes
    (B = 1, KVH = 8, G = 4): 32 segments at either length."""
    n_seg = prefill_attn.colsum_segments(P, 4)[1]
    assert n_seg == prefill_attn.MAX_SEGMENTS and 4 * 2 * n_seg * 1 * 8 * P == bytes_


#: K1/K2/K10's output widths at the 8B shapes: wqkv, wo (and K10's wq and
#: w2's output), w13, K10's wk/wv and w1/w3, the int4 head, and a ragged OUT.
GEMV_OUTS = [6144, 4096, 28672, 1024, 14336, 128256, 1000]
H100_SMS = 132


def _last_round_busy(L, OUT, cols):
    """The busy fraction of the last round of K1's tiles on the card."""
    rounds = -(-OUT // cols) * -(-L // qmm.GEMV_ROWS) / H100_SMS
    return rounds / math.ceil(rounds)


@pytest.mark.parametrize("L", [1, 5, 32])
@pytest.mark.parametrize("OUT", GEMV_OUTS)
def test_gemv_partition_fills_the_card(OUT, L):
    """Every shape whose narrowest tiles number at least one per SM gets a
    tile on every SM, at a width whose last round of tiles is within 2% as
    busy as the best width's; narrower outputs get the narrowest tiles."""
    cols = qmm.gemv_partition(L, OUT, H100_SMS)
    assert cols in qmm.GEMV_COLS
    row_blocks = -(-L // qmm.GEMV_ROWS)
    fill = [c for c in qmm.GEMV_COLS if -(-OUT // c) * row_blocks >= H100_SMS]
    if not fill:
        assert cols == qmm.GEMV_COLS[-1]
        return
    assert cols in fill
    best = max(_last_round_busy(L, OUT, c) for c in fill)
    assert _last_round_busy(L, OUT, cols) >= best - 0.02


@pytest.mark.parametrize("OUT,L,want", [
    (128256, 1, 32),  # the int4 head: 4008 tiles, 30.4 rounds of 132
    (28672, 1, 32),   # w13: 896 tiles, 6.8 rounds
    (6144, 1, 16),    # wqkv: 384 tiles, 2.9 rounds (32 columns: 1.45)
    (4096, 1, 16),    # wo, w2: 32 columns would leave 4 SMs without a tile
    (1024, 1, 16),    # K10's wk/wv: 64 tiles, half the card
    (14336, 1, 16),   # K10's w1/w3: 896 tiles, 6.8 rounds (32 columns: 3.4)
    (4096, 32, 64),   # 8 row blocks fill the card alone
    (1000, 5, 16),    # ragged OUT, two row blocks: 126 tiles
])
def test_gemv_partition_of_the_main_path(OUT, L, want):
    assert qmm.gemv_partition(L, OUT, H100_SMS) == want


def test_gemv_partition_takes_the_widest_of_equals():
    """Where widths share the card equally well, the widest is taken (fewer
    tiles, each CTA's activations serve more columns)."""
    assert qmm.gemv_partition(1, 132 * 64, H100_SMS) == 64
    assert qmm.gemv_partition(1, 132 * 32, H100_SMS) == 32


#: K8's shapes at prefill: the four 8B projections at the main path's prompt
#: (7928 rows) and at 8192, and ragged sizes of the on-card tests.
GEMM_SHAPES = [(7928, 6144), (7928, 4096), (7928, 28672), (8192, 6144), (8192, 28672),
               (1000, 1000), (33, 136), (256, 200), (129, 4096), (7928, 128256)]


@pytest.mark.parametrize("L,OUT", GEMM_SHAPES)
def test_gemm_schedule_covers_every_tile_once(L, OUT):
    """K8's persistent schedule visits every (weight-column, row) tile
    exactly once, over CTAs that each take tiles t, t + CTAs, ..."""
    ctas, group = qmm.gemm_schedule(L, OUT, H100_SMS)
    n_out, n_rows = -(-OUT // qmm.GEMM_TILE_OUT), -(-L // qmm.GEMM_TILE_ROWS)
    tiles = n_out * n_rows
    seen = [qmm.gemm_tile(t, L, OUT, group) for b in range(ctas) for t in range(b, tiles, ctas)]
    assert sorted(seen) == [(o, r) for o in range(n_out) for r in range(n_rows)]


@pytest.mark.parametrize("L,OUT", GEMM_SHAPES)
def test_gemm_schedule_keeps_every_sm_busy(L, OUT):
    """One CTA per SM where the tiles allow, none idle: every CTA gets a
    tile, and their counts differ by at most one."""
    ctas, group = qmm.gemm_schedule(L, OUT, H100_SMS)
    tiles = -(-OUT // qmm.GEMM_TILE_OUT) * -(-L // qmm.GEMM_TILE_ROWS)
    assert ctas == min(tiles, H100_SMS)
    counts = [len(range(b, tiles, ctas)) for b in range(ctas)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert 1 <= group <= -(-OUT // qmm.GEMM_TILE_OUT)


@pytest.mark.parametrize("L,OUT", [(8192, 6144), (7928, 28672), (8192, 4096)])
def test_gemm_schedule_keeps_tiles_in_flight_compact(L, OUT):
    """The tiles the card runs at once (the first CTAs' worth of the order)
    span ``group`` weight-column tiles and few row tiles, so their weights
    and activations stay in L2: at most 16 column tiles by 9 row tiles on
    132 SMs, where row-major order would span all column tiles."""
    ctas, group = qmm.gemm_schedule(L, OUT, H100_SMS)
    assert group == 16
    first = [qmm.gemm_tile(t, L, OUT, group) for t in range(ctas)]
    assert len({o for o, _ in first}) <= group
    assert len({r for _, r in first}) <= -(-ctas // group)


#: K9's output widths: the int8 head, the four fused layer projections of an
#: int8 checkpoint, K10's narrow wk/wv width and a ragged OUT.
W8A8_OUTS = [128256, 6144, 4096, 28672, 1024, 1000]


@pytest.mark.parametrize("L", [1, 4, 5, 8, 9, 32])
@pytest.mark.parametrize("OUT", W8A8_OUTS)
def test_w8a8_partition_covers_every_column_once_and_fills_the_card(OUT, L):
    """K9's tiles of the chosen width hold every output column exactly once,
    and occupy at least 70% of the SMs wherever the narrowest tiles could;
    no wider width would also do so (the widest that does is taken)."""
    cols = qmm.w8a8_partition(L, OUT, H100_SMS)
    assert cols in qmm.GEMV_COLS
    tiles = [(t * cols, min(OUT, t * cols + cols)) for t in range(-(-OUT // cols))]
    assert [c for b, e in tiles for c in range(b, e)] == list(range(OUT))
    row_blocks = -(-L // qmm.W8A8_ROWS)

    def fills(c):
        return -(-OUT // c) * row_blocks >= qmm.W8A8_MIN_FILL * H100_SMS

    if not fills(qmm.GEMV_COLS[-1]):
        assert cols == qmm.GEMV_COLS[-1]
        return
    assert fills(cols)
    assert not any(fills(c) for c in qmm.GEMV_COLS if c > cols)


@pytest.mark.parametrize("OUT,L,want", [
    (128256, 1, 64),  # the int8 head: 2004 tiles
    (6144, 1, 64),    # wqkv: 96 tiles, 73% of the SMs (fastest on the card)
    (4096, 1, 32),    # wo, w2: 128 tiles (64 columns would leave half the card idle)
    (28672, 1, 64),   # w13
    (4096, 5, 32),    # five rows: one row block of up to 8
    (4096, 9, 64),    # two row blocks: 128 tiles of 64 columns
    (1000, 1, 16),    # narrow: 63 tiles even at 16 columns
])
def test_w8a8_partition_of_the_paths(OUT, L, want):
    assert qmm.w8a8_partition(L, OUT, H100_SMS) == want
