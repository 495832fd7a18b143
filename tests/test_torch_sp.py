"""The port's sequence parallelism (``parallel/sp.py``: ``sp_prefill`` and
the query-block forms of K4 and K6 it runs) against the JAX package's
``sp_prefill`` on ``tests/test_sp.py``'s cases (``tests/
parallel_cases.py``: the cases, their bounds and the gaps measured), over
four gloo ranks started once for the module; and the plain versions of the
query-block kernels against the JAX package's ``chunked_prefill_partial``
and ``_profile_partial``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.caches.hybrid import _profile_partial as jax_profile_partial
from cold_compress_tpu.ops.attention import chunked_prefill_partial as jax_partial

from cold_compress_tpu_torch.ops import prefill_attn
from parallel_cases import N_DECODE, check_case, launch_cases, specs, within
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SP_CASES = ["sp4_full", "sp4_heavy_hitter", "sp4_recent_global", "sp4_hybrid", "sp4_int4"]


@pytest.fixture(scope="module")
def ranks():
    return launch_cases(SP_CASES)


@pytest.mark.parametrize("case", SP_CASES)
def test_parallel_prefill_matches_jax(ranks, case):
    """sp = 4 over f32 TestTiny (full, heavy_hitter, recent_global, hybrid)
    and int4 weights: every rank against the JAX package's ``sp_prefill``
    (``parallel_cases.check_case``)."""
    check_case(ranks, case)


def test_sp_int4_decode_tokens_agree_across_ranks(ranks):
    """int4 under sp = 4: the caches the ranks fill are the same on every
    rank, so their greedy continuations are too."""
    toks = [r[2] for r in ranks["sp4_int4"]]
    assert all(t == toks[0] for t in toks) and len(toks[0]) == N_DECODE + 1


@pytest.mark.parametrize("q_offset,Pq,Pk", [(0, 64, 64), (32, 32, 128), (64, 64, 128),
                                            (96, 32, 128), (0, 32, 160)])
def test_partial_attention_matches_jax_chunked_prefill_partial(q_offset, Pq, Pk):
    """The plain versions of K4's and K6's query-block forms (CPU tensors)
    against the JAX package's ``chunked_prefill_partial`` and
    ``_profile_partial``: a block of Pq rows at ``q_offset`` against Pk
    keys, a padded prompt: y (bf16) within one bf16 unit per element, the
    raw sums within 1e-5 of the largest reference element (f32 sums in
    another order; measured up to 1.8e-7)."""
    rng = np.random.RandomState(q_offset + Pq)
    B, H, KVH, D, plen = 1, 4, 2, 16, min(Pk, q_offset + Pq) - 5
    q = rng.randn(B, H, Pq, D).astype(np.float32)
    k, v = (rng.randn(B, KVH, Pk, D).astype(np.float32) for _ in range(2))
    y, cum, obs = prefill_attn.flash_prefill_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), plen, q_offset=q_offset)
    jy, jcum, jobs = jax_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(plen),
                                 q_offset=q_offset, need_summary=True)
    # y is bf16 on both sides: f32 values a summation order apart may round
    # to neighbouring bf16 values (one unit, 2**-7 of the element at most).
    gap = np.abs(y.numpy().astype(np.float64) - np.asarray(jy, np.float64))
    assert np.all(gap <= 2**-7 * np.abs(np.asarray(jy, np.float64)) + 1e-6), gap.max()
    for got, want, what in ((cum, jcum, "cum"), (obs, jobs, "obs")):
        within(got.numpy(), np.asarray(want), 1e-5, what)
    spec = specs("sp4_hybrid", False)[0]
    windows = tuple(sorted({max(1, int(s.recent_window * Pk)) for s in spec.hybrid_strategies
                            if "window" in s.strategy}))
    _, pcum, wcols = prefill_attn.flash_profile_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), plen, windows,
        q_offset=q_offset)
    jcum, jw = jax_profile_partial(spec, jnp.asarray(q), jnp.asarray(k), jnp.int32(plen),
                                   q_offset=q_offset)
    within(pcum.numpy(), np.asarray(jcum), 1e-5, "profile cum")
    within(wcols.numpy(), np.asarray(jw), 1e-5, "profile wcols")


def test_partial_block_items_cover_every_valid_row():
    """Pass 2's work items over a query block (``colsum_items`` with an
    offset, at the phase-2 shapes of ``chip_smoke.py``, a pipeline chunk's
    keys ending before the prompt does among them): for each key block, the
    rows that see it, ``[max(key0 - q_offset, 0) G, n_valid G)`` with
    ``n_valid`` counted from the whole prompt's length, tiled without
    overlap; no item for the keys past the block's last row."""
    G = 4
    for P, q_offset, Pk, plen in ((64, 8128, 8192, 7928), (64, 4096, 4160, 7928),
                                  (4096, 4096, 8192, 7928), (2048, 6144, 8192, 7928),
                                  (4096, 0, 8192, 7928), (64, 128, 256, 150)):
        items = prefill_attn.colsum_items(P, G, plen, q_offset, Pk)
        n_valid = max(0, min(plen - q_offset, P))
        for kb in range(-(-Pk // prefill_attn.KEYS_PER_ITEM)):
            spans = sorted((r0, r1) for b, _, r0, r1 in items if b == kb)
            begin = max(kb * prefill_attn.KEYS_PER_ITEM - q_offset, 0) * G
            if begin >= n_valid * G:
                assert not spans, (P, q_offset, kb)
                continue
            assert spans[0][0] == begin and spans[-1][1] == n_valid * G
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
