"""A tiny Mellum2 cell for the CPU tests: one period of the layer pattern
(three sliding layers of a 128-token window, then a full layer), dim 256,
2/1 heads of 128, 8 experts of width 128 with top 4, YaRN on the full layer
over 32 original positions (factor 4), vocabulary 512; prompts of 150-240
tokens, 10 new tokens, a 256-slot kv8 heavy-hitter cache on the full layer
(longer than every sequence: no eviction there hides a fault). Window and
cache are multiples of 128, so decode attention takes the integer-dot
branch in both kinds of layer, as in the cell."""

from __future__ import annotations

import copy

from portbench import spec

FULL, SLIDING = "full_attention", "sliding_attention"

CONFIG = {
    "source": "the port's TestMellum2 registry entry: Mellum2 cut to one period at tiny widths",
    "attention_bias": False, "head_dim": 128, "hidden_size": 256, "num_attention_heads": 2,
    "num_key_value_heads": 1, "num_hidden_layers": 4, "vocab_size": 512,
    "layer_types": [SLIDING, SLIDING, SLIDING, FULL], "mlp_layer_types": ["sparse"] * 4,
    "sliding_window": 128, "moe_intermediate_size": 128, "intermediate_size": 128,
    "num_experts": 8, "num_experts_per_tok": 4, "norm_topk_prob": True, "rms_norm_eps": 1e-06,
    "rope_parameters": {
        FULL: {"rope_type": "yarn", "rope_theta": 500000, "factor": 4,
               "original_max_position_embeddings": 32, "beta_fast": 32, "beta_slow": 1,
               "attention_factor": 1.1386294361119891},
        SLIDING: {"rope_type": "default", "rope_theta": 500000}},
    "port": {"architecture": "mellum2", "registry_name": "TestMellum2", "set": {},
             "qkv_bias": False, "terminators": [2], "weights": {"group_size": 128}},
}

LENGTHS = [150, 200, 240]

TRAFFIC = {
    "calls": [[n] for n in LENGTHS],
    "max_new_tokens": 10,
    "cache": {"strategy": "heavy_hitter", "max_cache_length": 256, "bits": 8,
              "prompt_compression": "heavy_hitter", "global_tokens": 4, "recent_window": 10},
    "check": {"min_tokens": 20, "max_lanes": 3},
}

#: As the dense tiny cell's: on the CPU the program runs the plain versions.
LIMITS = {"kv_rel_err_l0": 0.01, "pos_miss_l0": 0.02}


def cell(batch: int = 1) -> spec.Cell:
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    traffic = copy.deepcopy(TRAFFIC)
    if batch > 1:
        traffic["calls"] = [[LENGTHS[i % len(LENGTHS)] for i in range(batch)]]
    name = "tiny_mellum2.batch" if batch > 1 else "tiny_mellum2.single"
    return spec.Cell(name=name, chips=1, config_name="tiny_mellum2",
                     config=copy.deepcopy(CONFIG), traffic_name=name, traffic=traffic,
                     limits=dict(LIMITS), end_to_end=bench["end_to_end"],
                     per_layer=[m for m in bench["per_layer"]
                                if batch > 1 or m["name"] != "lane_util_pct"])
