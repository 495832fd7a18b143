"""The port's W4A8 matmul (kernel K1/K2) and int4 weight handling against
the JAX package.

The port's kernel wrapper takes its plain version on CPU tensors, so these
tests hold the plain version (the kernel's arithmetic) against the TPU
kernels run in Pallas interpret mode.

Run as a script (``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_qmm.py``), it
prints the gaps that the K10 and vocab-head tests bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cold_compress_tpu.models.config import ModelConfig as JaxModelConfig
from cold_compress_tpu.ops import linear as JL
from cold_compress_tpu.ops.pallas_qmm import qmm_w4a8_cp_stacked, qmm_w4a8_cpt
from cold_compress_tpu.quantization import weight_quant as JW
from cold_compress_tpu.runtime.engine import _flatten

from cold_compress_tpu_torch.models.config import ModelConfig
from cold_compress_tpu_torch.ops import linear as TL
from cold_compress_tpu_torch.ops import qmm
from cold_compress_tpu_torch.quantization import weight_quant as TW
from cold_compress_tpu_torch.runtime.engine import params_from_flat


def _leaf(rng, IN, OUT, gs=128):
    """A JAX int4 rowpack leaf quantized from random normal weights (real
    scales and zeros, unlike the constant ones of random_quantized_params)."""
    return JW.quantize_weight_int4(
        jnp.asarray(rng.randn(IN, OUT).astype(np.float32) * 0.05), group_size=gs
    )


def _torch_leaf(leaf):
    """The port's kernel layout of a JAX rowpack leaf, carried over through
    the checkpoint key scheme (numpy only)."""
    flat = _flatten(leaf)
    tree = params_from_flat(flat, "cpu")
    return qmm.rowpack_to_gemv(tree["w"], tree["scales"], tree["zeros"])


def _x(rng, L, IN):
    return rng.randn(L, IN).astype(np.float32)


def _bf16(a):
    """numpy f32 -> the bf16 tensor both sides see."""
    return torch.from_numpy(a).to(torch.bfloat16)


# Tolerance: both sides quantize the same bf16 activations to the same int8
# values and form exact integer group dots; they differ only in f32
# summation order and in the TPU sidecar's bf16 rounding of the pre-summed
# zero term (z - 8 s), a relative error of at most 2**-9 on that term.
QMM_RTOL = 4e-3


@pytest.mark.parametrize("L", [1, 5])
def test_w4a8_plain_matches_tpu_cpt_kernel(L):
    """Layer projections: the port's W4A8 against ``qmm_w4a8_cpt``
    (interpret mode) on a stacked leaf after to_cpt(to_colpack(...)),
    layer index selected inside the kernel."""
    rng = np.random.RandomState(L)
    IN, OUT, NL = 512, 768, 2
    leaves = [_leaf(rng, IN, OUT) for _ in range(NL)]
    stacked = JL.QuantizedWeight(
        w=jnp.stack([lf.w for lf in leaves]),
        scales=jnp.stack([lf.scales for lf in leaves]),
        zeros=jnp.stack([lf.zeros for lf in leaves]),
        kind="int4", group_size=128,
    )
    cpt = JL.to_cpt(JL.to_colpack(stacked))
    assert cpt.w.ndim == 4
    x = _x(rng, L, IN)
    xb = jnp.asarray(x, jnp.bfloat16)
    for i, leaf in enumerate(leaves):
        ref = np.asarray(
            qmm_w4a8_cpt(xb, cpt.w, cpt.scales, i, group_size=128,
                         interpret=True, inkq=True)
        )
        wg, sz = _torch_leaf(leaf)
        got = qmm.w4a8_gemv(_bf16(x), wg, sz, 128, counter="w4a8_gemv.wqkv").numpy()
        assert got.shape == (L, OUT)
        np.testing.assert_allclose(got, ref, rtol=0, atol=QMM_RTOL * np.abs(ref).max())


def test_w4a8_plain_matches_tpu_tiled_head_kernel():
    """Vocab head: the tiled branch of ``qmm_w4a8_cp_stacked`` (the int4
    head's kernel) with an OUT that is no multiple of any tile; the TPU
    pads and slices, the port masks the ragged edge."""
    rng = np.random.RandomState(7)
    IN, OUT = 512, 1000
    leaf = _leaf(rng, IN, OUT)
    tiled = JL.to_colpack_tiled(leaf, tile_out=128)
    assert tiled.w.shape[0] * tiled.w.shape[2] * 2 > OUT  # padded
    x = _x(rng, 1, IN)
    ref = np.asarray(
        qmm_w4a8_cp_stacked(
            jnp.asarray(x, jnp.bfloat16), tiled.w[None], tiled.scales[None],
            tiled.zeros[None], 0, group_size=128, interpret=True,
        )
    )[:, :OUT]
    wg, sz = _torch_leaf(leaf)
    got = qmm.w4a8_gemv(_bf16(x), wg, sz, 128, counter="w4a8_gemv.head").numpy()
    assert got.shape == (1, OUT)
    # No pre-summed zero term in this layout: only summation order differs.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_activation_quantization_matches_tpu():
    """Per-row int8 activation quantization (round half to even, true
    division by sx) is bit-identical to the TPU kernels' prologue."""
    from cold_compress_tpu.ops.pallas_qmm import _quantize_rows

    rng = np.random.RandomState(3)
    x = _x(rng, 5, 512)
    x[0, :4] = [0.5, 1.5, -2.5, 127.0]  # ties and the absmax itself
    xq_ref, sx_ref = _quantize_rows(jnp.asarray(x, jnp.bfloat16))
    xq, sx = qmm.quantize_activations(_bf16(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_ref, np.float32))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_ref))


@pytest.mark.parametrize("legacy_uint8", [False, True])
def test_rowpack_dequant_matches_jax(legacy_uint8):
    """Rowpack dequantization, and the kernel layout's dequantization used
    by prefill, are exactly the JAX package's ``dequantize_weight``."""
    rng = np.random.RandomState(4)
    leaf = _leaf(rng, 256, 384, gs=64)
    ref = np.asarray(JL.dequantize_weight(leaf, jnp.float32))
    w = torch.from_numpy(np.array(leaf.w))
    if legacy_uint8:  # unsigned-nibble checkpoints
        w = (w.view(torch.uint8) ^ 0x80)
    s = torch.from_numpy(np.array(leaf.scales.view(jnp.uint16)).view(np.int16)).view(torch.bfloat16)
    z = torch.from_numpy(np.array(leaf.zeros.view(jnp.uint16)).view(np.int16)).view(torch.bfloat16)
    got = TL.dequantize_weight(w, s, z, 64, dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
    lin = TL.QuantizedLinear.from_rowpack(w, s, z, 64, counter="w4a8_gemv.wo")
    np.testing.assert_array_equal(lin.dense(torch.float32).numpy(), ref)
    assert (lin.in_features, lin.out_features) == (256, 384)


def test_quantized_linear_routes_by_row_count():
    """L <= 32 rows run the W4A8 kernel (counted); larger L dequantizes to
    bf16 and matches the JAX package's XLA fallback."""
    rng = np.random.RandomState(5)
    leaf = _leaf(rng, 256, 256)
    wg, sz = _torch_leaf(leaf)
    lin = TL.QuantizedLinear(wg, sz, 128, counter="w4a8_gemv.wo")
    x = _x(rng, 40, 256)
    before = qmm.LAUNCHES["w4a8_gemv.wo"]
    y = lin(_bf16(x))  # prefill-sized: dense bf16 path
    jax_leaf = dict(leaf.__dict__)
    ref = np.asarray(JL.linear(jnp.asarray(x, jnp.bfloat16), leaf), np.float32)
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())
    assert jax_leaf["kind"] == "int4"
    # CPU tensors take the plain version and never count as a launch.
    lin(_bf16(x[:1]))
    assert qmm.LAUNCHES["w4a8_gemv.wo"] == before


def test_random_quantized_params_byte_identical():
    """The port's numpy ``random_quantized_params`` gives the JAX package's
    bytes (int4 layers and int4 head) under the checkpoint key scheme."""
    cfg_j = JaxModelConfig.from_name("TestKernel")
    ref = _flatten(JW.random_quantized_params(cfg_j, seed=3, head_mode="int4"))
    got = TW.random_quantized_params(ModelConfig.from_name("TestKernel"), seed=3)
    assert sorted(got) == sorted(ref)
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_effective_group_size():
    for in_dim, gs in [(4096, 128), (288, 128), (14336, 128), (100, 128)]:
        assert TW.effective_group_size(in_dim, gs) == JW.effective_group_size(in_dim, gs)


def test_checkpoint_file_round_trip(tmp_path):
    """A params tree saved by the JAX package loads into the port."""
    from cold_compress_tpu.runtime.engine import save_params

    from cold_compress_tpu_torch.runtime.engine import load_params

    cfg = JaxModelConfig.from_name("TestKernel")
    params = JW.random_quantized_params(cfg, seed=1, head_mode="int4")
    path = tmp_path / "model.npz"
    save_params(params, str(path))
    tree = load_params(str(path), "cpu")
    assert len(tree["layers"]) == cfg.n_layer
    wq = tree["layers"][1]["attn"]["wq"]
    assert wq["group_size"] == 128
    assert wq["w"].dtype == torch.int8
    np.testing.assert_array_equal(wq["w"].numpy(), np.asarray(params["layers"][1]["attn"]["wq"].w))
    emb = tree["tok_embeddings"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(), np.asarray(params["tok_embeddings"], np.float32)
    )
    assert jax.devices()[0].platform == "cpu"


# ---------------------------------------------------------------------------
# W8A8 vocab head (K9)
# ---------------------------------------------------------------------------


def _int8_head(rng, IN, OUT):
    """A JAX int8 leaf as random_quantized_params(head_mode="int8") draws
    it, with per-column scales that are not all equal."""
    w = ((rng.randint(0, 256, size=(IN, OUT)).astype(np.uint8) % 255).astype(np.int8) - 127)
    s = (rng.rand(OUT).astype(np.float32) + 0.5) * (0.02 / 127)
    return JL.QuantizedWeight(w=jnp.asarray(w), scales=jnp.asarray(s), kind="int8")


@pytest.mark.parametrize("L", [1, 7, 32])
def test_w8a8_plain_matches_tpu_tiled_kernel_bit_for_bit(L):
    """Against qmm_w8a8_tiled in interpret mode on the tiled layout (OUT
    padded there, sliced here): the same int8 activations, an exact int32
    dot and the same f32 epilogue order (d * s) * sx give the same bits."""
    from cold_compress_tpu.ops.pallas_qmm import qmm_w8a8_tiled

    rng = np.random.RandomState(L)
    IN, OUT = 512, 1000
    leaf = _int8_head(rng, IN, OUT)
    x = _x(rng, L, IN)
    tiled = JL.to_tiled_int8(leaf, tile_out=128)
    ref = qmm_w8a8_tiled(jnp.asarray(x, jnp.bfloat16), tiled.w, tiled.scales, interpret=True)
    ref = np.asarray(ref)[:, :OUT]
    tree = params_from_flat(_flatten(leaf), "cpu")
    assert tree["kind"] == "int8" and tree["w"].dtype == torch.int8
    wt, s = qmm.int8_to_gemv(tree["w"], tree["scales"])
    y = qmm.w8a8_gemv(_bf16(x), wt, s, counter="w8a8_gemv.head")
    assert y.dtype == torch.float32 and y.numpy().tobytes() == ref.tobytes()


def test_int8_linear_routes_by_rows_and_matches_jax_linear():
    """Int8Linear: L <= 32 takes K9's plain version; L = 40 dequantizes to
    bf16 and calls matmul, as JAX's linear does outside Pallas (the same
    bf16 weights, f32-accumulated products, bf16 result)."""
    rng = np.random.RandomState(3)
    IN, OUT = 256, 384
    leaf = _int8_head(rng, IN, OUT)
    tree = params_from_flat(_flatten(leaf), "cpu")
    lin = TL.Int8Linear(tree["w"], tree["scales"], counter="w8a8_gemv.head")
    x = _x(rng, 40, IN)
    ref = np.asarray(JL.linear(jnp.asarray(x, jnp.bfloat16), leaf), np.float32)
    got = lin(_bf16(x)).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(
        lin.dense(torch.float32).numpy(),
        np.asarray(JL.dequantize_weight(leaf, jnp.float32)),
    )
    small = lin(_bf16(x[:3])).float().numpy()
    k9 = qmm.w8a8_gemv_plain(_bf16(x[:3]), lin.w, lin.s).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(small, k9)


def test_random_int8_head_keys_match_jax():
    """random_quantized_params(head_mode="int8"): the same numpy draws, so
    the flat key scheme holds the same bytes as the JAX package's."""
    ref = _flatten(JW.random_quantized_params(JaxModelConfig.from_name("TestKernel"),
                                              head_mode="int8"))
    got = TW.random_quantized_params(ModelConfig.from_name("TestKernel"), head_mode="int8")
    assert set(ref) == set(got)
    for key in ("output/w", "output/scales", "output/qmeta", "layers/1/ffn/w2/w"):
        a, b = np.asarray(ref[key]), np.asarray(got[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key


# ---------------------------------------------------------------------------
# W4A8 at prefill size (K8)
# ---------------------------------------------------------------------------


def _stacked(leaves):
    return JL.QuantizedWeight(
        w=jnp.stack([lf.w for lf in leaves]), scales=jnp.stack([lf.scales for lf in leaves]),
        zeros=jnp.stack([lf.zeros for lf in leaves]), kind="int4", group_size=128,
    )


@pytest.mark.parametrize("L", [64, 300])
def test_w4a8_prefill_plain_matches_tpu_prefill_kernels(L):
    """K8's plain version (K1's function at any L) against
    ``qmm_w4a8_prefill`` on the colpack layout (interpret mode, rows padded
    to its 256-row tile): the same int8 activations and exact group dots,
    so only f32 order differs (1e-4 of max|y|). Against
    ``qmm_w4a8_prefill_cpt``, whose sidecar rounds z - 8s to bf16: K1's
    documented deviation, one bf16 rounding of each element's zero term
    (at these row counts a few elements exceed the decode tests' 4e-3 of
    max|y|: up to 0.030 against 0.020 at L = 64)."""
    from cold_compress_tpu.ops.pallas_qmm import qmm_w4a8_prefill, qmm_w4a8_prefill_cpt

    rng = np.random.RandomState(L)
    IN, OUT, NL = 512, 768, 2
    leaves = [_leaf(rng, IN, OUT) for _ in range(NL)]
    colpack = JL.to_colpack(_stacked(leaves))
    cpt = JL.to_cpt(colpack)
    x = _x(rng, L, IN)
    xb = jnp.asarray(x, jnp.bfloat16)
    for i, leaf in enumerate(leaves):
        wg, sz = _torch_leaf(leaf)
        before = qmm.LAUNCHES["w4a8_gemm.w13"]
        got = qmm.w4a8_gemm(_bf16(x), wg, sz, 128, counter="w4a8_gemm.w13").numpy()
        assert qmm.LAUNCHES["w4a8_gemm.w13"] == before  # CPU: the plain version
        assert got.shape == (L, OUT)
        ref = np.asarray(qmm_w4a8_prefill(xb, colpack.w, colpack.scales, colpack.zeros, i,
                                          group_size=128, interpret=True))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        ref_cpt = np.asarray(qmm_w4a8_prefill_cpt(xb, cpt.w, cpt.scales, i, group_size=128,
                                                  interpret=True))
        # Per element: one bf16 rounding of each group's z - 8s (relative
        # 2**-8 at most: 8 significant bits) in the zero term
        # sx * sum_g (z_g - 8 s_g) * xs_g, counted in magnitude.
        xq, sx = qmm.quantize_activations(_bf16(x))
        xs = xq.reshape(L, -1, 128).sum(-1).abs().numpy()  # [L, ng]
        s = np.asarray(leaf.scales, np.float32)
        z = np.asarray(leaf.zeros, np.float32)
        zero_term = sx.numpy() * (xs @ np.abs(z - 8 * s))
        err = np.abs(got - ref_cpt)
        assert np.all(err <= 2**-8 * zero_term + 1e-4 * np.abs(ref_cpt).max())
        # Only the low-nibble half of the cpt columns carries z - 8s; the
        # high half stores z itself and agrees as tightly as colpack.
        np.testing.assert_allclose(got[:, OUT // 2:], ref_cpt[:, OUT // 2:], rtol=0,
                                   atol=1e-4 * np.abs(ref_cpt).max())


def test_quantized_linear_prefill_w4a8_route():
    """``prefill_w4a8=True`` sends L > 32 rows to K8 (its plain version
    here, counted under ``w4a8_gemm.<name>`` only on the card) and leaves
    L <= 32 on K1; ``build_model(prefill_w4a8=True)`` sets it on the four
    layer projections and not on the head."""
    from cold_compress_tpu_torch.models.config import ModelConfig as TCfg
    from cold_compress_tpu_torch.runtime.engine import build_model

    rng = np.random.RandomState(6)
    leaf = _leaf(rng, 256, 256)
    wg, sz = _torch_leaf(leaf)
    lin = TL.QuantizedLinear(wg, sz, 128, counter="w4a8_gemv.wo", prefill_w4a8=True)
    x = _x(rng, 40, 256)
    y = lin(_bf16(x))
    want = qmm.w4a8_gemv_plain(_bf16(x), wg, sz, 128).to(torch.bfloat16)
    assert torch.equal(y, want)
    lin.prefill_w4a8 = False
    assert not torch.equal(lin(_bf16(x)), y)  # the bf16 dequant path
    cfg = TCfg.from_name("TestKernel")
    flat = TW.random_quantized_params(cfg, seed=0)
    model = build_model(cfg, params_from_flat(flat, "cpu"), "cpu", max_positions=512,
                        prefill_w4a8=True)
    layer = model.layers[1]
    assert all(m.prefill_w4a8 for m in (layer.attention.wqkv, layer.attention.wo,
                                         layer.feed_forward.w13, layer.feed_forward.w2))
    assert not model.output.prefill_w4a8


# ---------------------------------------------------------------------------
# K10: the TPU's older layouts of K1's function, run by the port as K1 after
# its one rowpack repack
# ---------------------------------------------------------------------------

K10_IN, K10_OUT = 512, 512  # IN % 256, OUT % 128 and (IN / 2) % gs: every TPU gate


def _k10_cpt_split(stacked):
    """The stacked leaf as CCT_QMM_SPLIT=2 lays it out: cpt tiles of 128
    columns (two per layer) split into two buffers."""
    return JL.to_cpt_split(JL.to_cpt(JL.to_colpack(stacked), tile_out=128), 2)


def _k10_ref(kernel, x, leaves, stacked):
    """Layer 1's output of one TPU K10 function in interpret mode."""
    from cold_compress_tpu.ops import pallas_qmm as P

    if kernel == "qmm_w4a8":
        lf = leaves[1]
        return P.qmm_w4a8(x, lf.w, lf.scales, lf.zeros, group_size=128, interpret=True)
    if kernel == "qmm_w4a8_stacked":
        return P.qmm_w4a8_stacked(x, stacked.w, stacked.scales, stacked.zeros, 1,
                                  group_size=128, interpret=True)
    if kernel == "qmm_w4a8_cp_stacked":
        cp = JL.to_colpack(stacked)
        assert cp.w.ndim == 3  # the flat branch
        return P.qmm_w4a8_cp_stacked(x, cp.w, cp.scales, cp.zeros, 1, group_size=128,
                                     interpret=True)
    split = _k10_cpt_split(stacked)
    assert len(split.w) == 2 and split.w[0].shape == (2, 1, K10_IN, 128)
    return P.qmm_w4a8_cpt_split(x, list(split.w), list(split.scales), 1, group_size=128,
                                interpret=True)


K10_KERNELS = ["qmm_w4a8", "qmm_w4a8_stacked", "qmm_w4a8_cp_stacked", "qmm_w4a8_cpt_split"]


def k10_outputs(kernel, L):
    """(K1's plain output, the TPU function's, each element's zero term
    ``sx * sum_g |xs_g| |z_g - 8 s_g|``) for layer 1 of a two-layer stack of
    rowpack leaves quantized from normal weights (scales and zeros vary
    per group)."""
    rng = np.random.RandomState(100 + L)
    leaves = [_leaf(rng, K10_IN, K10_OUT) for _ in range(2)]
    x = _x(rng, L, K10_IN)
    ref = np.asarray(_k10_ref(kernel, jnp.asarray(x, jnp.bfloat16), leaves, _stacked(leaves)))
    wg, sz = _torch_leaf(leaves[1])
    got = qmm.w4a8_gemv(_bf16(x), wg, sz, 128, counter="w4a8_gemv.wqkv").numpy()
    xq, sx = qmm.quantize_activations(_bf16(x))
    xs = xq.reshape(L, -1, 128).sum(-1).abs().numpy()
    s = np.asarray(leaves[1].scales, np.float32)
    z = np.asarray(leaves[1].zeros, np.float32)
    return got, ref, sx.numpy() * (xs @ np.abs(z - 8 * s))


@pytest.mark.parametrize("L", [1, 5, 32])
@pytest.mark.parametrize("kernel", K10_KERNELS)
def test_k1_plain_matches_tpu_k10_kernels(kernel, L):
    """K1's plain version on the port's repack of a rowpack leaf (varying
    per-group scales and zeros from ``quantize_weight_int4``) against each
    K10 function on its own layout of the same bytes, made by the JAX
    package's repacks. Exact integer group dots on both sides: the rowpack
    and flat colpack functions differ only in f32 order (1e-4 of max|y|);
    ``qmm_w4a8_cpt_split`` also rounds each group's ``z - 8 s`` to bf16, so
    each element within 2**-8 of its zero term (ROADMAP section 3)."""
    got, ref, zero_term = k10_outputs(kernel, L)
    assert got.shape == ref.shape == (L, K10_OUT)
    tol = 1e-4 * np.abs(ref).max()
    if kernel != "qmm_w4a8_cpt_split":
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    else:
        assert np.all(np.abs(got - ref) <= 2**-8 * zero_term + tol)


@pytest.mark.parametrize("L", [1, 5, 32])
def test_rowpack_plain_matches_tpu_rowpack_kernel(L):
    """``w4a8_rowpack_plain``, the rowpack function on the unrepacked bytes
    (``z - 8 s`` kept in f32 for the low rows, as the TPU kernel keeps it),
    against ``qmm_w4a8`` in interpret mode and against K1's plain version."""
    from cold_compress_tpu.ops.pallas_qmm import qmm_w4a8

    rng = np.random.RandomState(200 + L)
    leaf = _leaf(rng, K10_IN, K10_OUT)
    x = _x(rng, L, K10_IN)
    ref = np.asarray(qmm_w4a8(jnp.asarray(x, jnp.bfloat16), leaf.w, leaf.scales, leaf.zeros,
                              group_size=128, interpret=True))
    tree = params_from_flat(_flatten(leaf), "cpu")
    got = qmm.w4a8_rowpack_plain(_bf16(x), tree["w"], tree["scales"], tree["zeros"], 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    wg, sz = qmm.rowpack_to_gemv(tree["w"], tree["scales"], tree["zeros"])
    k1 = qmm.w4a8_gemv_plain(_bf16(x), wg, sz, 128)
    np.testing.assert_allclose(got.numpy(), k1.numpy(), rtol=0, atol=1e-5 * np.abs(ref).max())


def head_logits_above_tpu_gate():
    """(the port's bf16 logits, the JAX package's) of an int4 head wider
    than the rowpack gate's 32768 columns: dim 256, vocab 32896, eight
    hidden rows as the final norm leaves them (unit RMS)."""
    from cold_compress_tpu.ops.pallas_qmm import w4a8_supported

    rng = np.random.RandomState(11)
    D, V = 256, 32896
    leaf = _leaf(rng, D, V)
    x = _x(rng, 8, D)
    xb = jnp.asarray(x, jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CCT_PALLAS_INTERPRET", "1")
        assert not w4a8_supported(xb.shape, leaf)  # the OUT <= 32768 gate
        ref = np.asarray(JL.linear(xb, leaf), np.float32)
    wg, sz = _torch_leaf(leaf)
    got = qmm.w4a8_gemv(_bf16(x), wg, sz, 128, counter="w4a8_gemv.head").to(
        torch.bfloat16).float().numpy()
    return got, ref


def test_int4_head_above_tpu_gate_w4a8_against_w4a16():
    """The known deviation on the JAX package's unstacked path: an int4
    head wider than the rowpack gate's 32768 columns (pallas_qmm.py:1436-
    1452) is a bf16 dequantized matmul there (W4A16, linear.py:648), while
    the port keeps K2 (W4A8). The logits differ by the activations' int8
    rounding, within 1e-2 of each row's max|logit| (0.59-0.86% measured),
    and the greedy token agrees on all eight rows (top-2 margins down to
    0.016 of a 3.1-4.0 max)."""
    got, ref = head_logits_above_tpu_gate()
    gap = np.abs(got - ref).max(axis=-1) / np.abs(ref).max(axis=-1)
    assert np.all(gap <= 1e-2), gap
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# int8 layer weights (K9 at the layer projections)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 5, 32])
def test_int8_layer_plain_matches_xla_w8a8_matmul(L):
    """An int8 layer leaf from ``quantize_weight_int8``: the JAX package's
    XLA ``w8a8_matmul`` (the int8 layer path at L <= 32) forms ``(d * sx) *
    s``, K9 ``(d * s) * sx``: the same exact integer dot and one f32
    rounding apart (2**-22 relative), so after the cast to bf16 each element
    agrees or differs by one bf16 unit (2**-7 of it)."""
    rng = np.random.RandomState(300 + L)
    IN, OUT = 256, 768
    leaf = JW.quantize_weight_int8(jnp.asarray(rng.randn(IN, OUT).astype(np.float32) * 0.05))
    x = _x(rng, L, IN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CCT_PALLAS_INTERPRET", "1")
        ref = np.asarray(JL.w8a8_matmul(jnp.asarray(x, jnp.bfloat16), leaf))
        ref_bf16 = np.asarray(JL.linear(jnp.asarray(x, jnp.bfloat16), leaf), np.float32)
    tree = params_from_flat(_flatten(leaf), "cpu")
    assert tree["kind"] == "int8" and tree["group_size"] == 128
    lin = TL.Int8Linear(tree["w"], tree["scales"], counter="w8a8_gemv.w13")
    got = qmm.w8a8_gemv_plain(_bf16(x), lin.w, lin.s).numpy()
    np.testing.assert_allclose(got, ref, rtol=2**-22, atol=0)
    got_bf16 = lin(_bf16(x)).float().numpy()
    assert np.all(np.abs(got_bf16 - ref_bf16) <= 2**-7 * np.abs(ref_bf16))


def test_int8_layers_fuse_and_route_to_k9():
    """int8 layer leaves concatenate on the output axis (``w`` and
    ``scales``) into ``Int8Linear``s counted as ``w8a8_gemv.<projection>``;
    the fused projection computes exactly the unfused ones."""
    from cold_compress_tpu_torch.models.transformer import fuse_layer_params
    from cold_compress_tpu_torch.runtime.engine import build_model

    cfg = ModelConfig.from_name("TestKernel")
    flat = TW.random_quantized_params(cfg, seed=2, mode="int8")
    tree = params_from_flat(flat, "cpu")
    fused = fuse_layer_params(tree)["layers"][0]
    attn = tree["layers"][0]["attn"]
    assert fused["attn"]["wqkv"]["kind"] == "int8"
    assert torch.equal(fused["attn"]["wqkv"]["w"],
                       torch.cat([attn["wq"]["w"], attn["wk"]["w"], attn["wv"]["w"]], -1))
    model = build_model(cfg, tree, "cpu", max_positions=512)
    layer = model.layers[0]
    for lin, name in ((layer.attention.wqkv, "wqkv"), (layer.attention.wo, "wo"),
                      (layer.feed_forward.w13, "w13"), (layer.feed_forward.w2, "w2")):
        assert isinstance(lin, TL.Int8Linear) and lin.counter == f"w8a8_gemv.{name}"
    assert isinstance(model.output, TL.Int8Linear)  # mode="int8" gives an int8 head
    x = _bf16(_x(np.random.RandomState(0), 1, cfg.dim))
    whole = layer.attention.wqkv(x)
    parts = torch.cat([TL.Int8Linear(attn[k]["w"], attn[k]["scales"], counter="w8a8_gemv.wqkv")(x)
                       for k in ("wq", "wk", "wv")], -1)
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("head_mode", ["int4", "int8"])
def test_random_int8_layers_byte_identical(head_mode):
    """``random_quantized_params(mode="int8")``: the JAX package's bytes
    under the checkpoint key scheme, its head int8 whatever ``head_mode``
    asks (the JAX function draws the head in the layers' mode)."""
    ref = _flatten(JW.random_quantized_params(JaxModelConfig.from_name("TestKernel"), seed=4,
                                              mode="int8", head_mode=head_mode))
    got = TW.random_quantized_params(ModelConfig.from_name("TestKernel"), seed=4, mode="int8",
                                     head_mode=head_mode)
    assert sorted(got) == sorted(ref)
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
    assert list(got["output/qmeta"]) == [8, 128]


if __name__ == "__main__":
    jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py
    for kernel in K10_KERNELS:
        for L in (1, 5, 32):
            got, ref, zero_term = k10_outputs(kernel, L)
            gap = np.abs(got - ref)
            print(f"{kernel} L={L}: max gap / max|y| {gap.max() / np.abs(ref).max():.3e}, "
                  f"max gap / zero term {(gap / np.maximum(zero_term, 1e-30)).max():.3e}")
    got, ref = head_logits_above_tpu_gate()
    top2 = np.sort(ref, -1)[:, -2:]
    print("int4 head above the gate: gap / max|logit| per row",
          np.round(np.abs(got - ref).max(-1) / np.abs(ref).max(-1), 5).tolist(),
          "| max|logit|", np.abs(ref).max(-1).tolist(),
          "| same argmax", bool((got.argmax(-1) == ref.argmax(-1)).all()),
          "| top-2 margins", (top2[:, 1] - top2[:, 0]).tolist())
