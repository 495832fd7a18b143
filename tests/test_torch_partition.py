"""How the kernels' wrappers cut their work: decode attention's cluster of
CTAs over the cache slots (K3/K5) and the prefill pass 2's work items of one
128-key block against one segment of query rows (K4/K6). Pure Python, so it
runs here; the kernels compute their ranges with the same formulas."""

import pytest

from cold_compress_tpu_torch.ops import decode_attn, prefill_attn


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
