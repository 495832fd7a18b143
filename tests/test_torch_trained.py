"""The port on trained weights: teacher-forced NLL of the trained
TinyByteLM128 fixture (head_dim 128 and G = 2, so every kernel gate of the
port passes) on real text, against the JAX package's, on the CPU.

The check is ``chip_smoke.py``'s (``TRAINED_CONFIGS``, ``trained_nll``;
phase 3 runs it on the card against the CPU): the criterion of
``tests/test_quality_gates.py`` (the first 400 bytes of ``BENCHMARK.md`` as
byte tokens, a 256-byte prompt, 96 teacher-forced bytes, mean NLL over the
forced bytes) in three configurations: int4 weights (``quantize_params``,
group size 128, int4 head) over a full bf16 cache; the trained bf16
weights over a kv8 ``heavy_hitter`` cache at a quarter of 512 slots (the
prompt is compressed, decode evicts); and over a kv8 ``hybrid`` cache with
``bench.py``'s FastGen menu (punctuation bytes as its punctuation class).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import TRAINED_CKPT, TRAINED_CONFIGS, TRAINED_MAX_SEQ, repo_path
from chip_smoke import trained_kw, trained_nll, trained_tokens
from cold_compress_tpu.models import transformer as JT
from cold_compress_tpu.quantization.weight_quant import quantize_params as jax_quantize_params
from cold_compress_tpu.runtime.engine import build_cache_specs as jax_build_specs
from cold_compress_tpu.runtime.engine import load_model as jax_load_model
from cold_compress_tpu.runtime.generate import generate as jax_generate

from cold_compress_tpu_torch.ops import kernel_launches
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: |port NLL - JAX NLL| in nats per byte; the bound of
#: test_quality_gates.py (0.02) where more than rounding moves it.
#: int4 (measured 0.0123): the port's W4A8 quantizes activations to int8
#: where the JAX XLA path keeps bf16. kv8 heavy_hitter (measured 0.0007):
#: the port's decode attention rounds q, K, V and the probabilities to bf16
#: where XLA keeps f32. hybrid (measured 0.0066): the same roundings, and a
#: heavy-hitter near-tie that keeps one other slot in one layer's head
#: (policy special_punc_heavy_hitter, no recent window) moves single
#: steps' log-probabilities by up to 0.25.
NLL_TOL = {"int4": 0.02, "kv8_heavy_hitter": 5e-3, "hybrid": 0.02}


@pytest.fixture(scope="module")
def jax_trained():
    return jax_load_model(repo_path(TRAINED_CKPT), model_name="TinyByteLM128")


@pytest.mark.parametrize("name", list(TRAINED_CONFIGS))
def test_teacher_forced_nll_matches_jax(jax_trained, name):
    cfg, params, rope = jax_trained
    if TRAINED_CONFIGS[name][0] == "int4":
        params = jax_quantize_params(params, mode="int4", group_size=128, output_mode="int4")
    caches = JT.init_caches(cfg, jax_build_specs(cfg, trained_kw(name), TRAINED_MAX_SEQ), 1,
                            jnp.bfloat16)
    prompt, forced = trained_tokens()
    _, info, _ = jax_generate(cfg, JT.fuse_layer_params(JT.stack_layer_params(params)), rope,
                              caches, prompt, len(forced), prefill_bucket=TRAINED_MAX_SEQ,
                              next_tokens=forced)
    probs = np.asarray(info["emitted_probs"], np.float64)
    ref = float(np.mean(-np.log(np.maximum(probs, 1e-20))))
    before = kernel_launches()
    got, steps = trained_nll(name, "cpu", attn_i8dot=False)  # JAX's XLA path dequantizes
    assert kernel_launches() == before  # CPU tensors: plain versions only
    assert steps == len(forced) - 1
    # Trained: far below the uniform ln(512) = 6.24 nats per byte.
    assert ref < 3.0 and got < 3.0, (ref, got)
    assert abs(got - ref) <= NLL_TOL[name], (name, ref, got)
