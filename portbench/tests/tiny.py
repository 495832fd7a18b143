"""A tiny cell for the CPU tests: the port's ``TestKernel`` registry entry
(2 layers, dim 256, 2/1 heads of 128, vocab 512), the mixes' shapes cut to
prompts of 160-400 tokens and a 128-slot kv8 heavy-hitter cache (a multiple
of 128, so decode attention takes the integer-dot branch, as in the
cells)."""

from __future__ import annotations

import copy

from portbench import spec

CONFIG = {
    "source": "the port's TestKernel registry entry",
    "hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 2,
    "num_hidden_layers": 2, "num_key_value_heads": 1, "vocab_size": 512,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-05,
    "port": {"registry_name": "TestKernel", "set": {}, "qkv_bias": False,
             "terminators": [2], "weights": {"group_size": 128}},
}

LENGTHS = [160, 230, 300, 400]

TRAFFIC = {
    "calls": [[n] for n in LENGTHS],
    "max_new_tokens": 12,
    "cache": {"strategy": "heavy_hitter", "max_cache_length": 128, "bits": 8,
              "prompt_compression": "heavy_hitter", "global_tokens": 4, "recent_window": 10},
    "check": {"min_tokens": 30, "max_lanes": 3},
}

#: The limits of the tiny cells, set as the cells' are. On the CPU the
#: program runs the plain versions, which the reference follows to the bit:
#: sound runs over seeds 0-11 read 0 on both numbers. The control (the
#: reference one step below every stated precision) reads a K/V gap of at
#: least 0.11 on seeds 0-2; a step that leaves the cache unchanged lacks
#: 0.086 of the positions, half a batch answered by the other half and an
#: altered token read a K/V gap of 0.40 and more (seeds 21-23).
LIMITS = {"kv_rel_err_l0": 0.01, "pos_miss_l0": 0.02}


def cell(batch: int = 1, bias: bool = False) -> spec.Cell:
    """The tiny cell, with ``batch`` lanes a call and Qwen2's q/k/v bias
    where asked."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    conf = copy.deepcopy(CONFIG)
    if bias:
        conf["port"]["set"] = {"attention_bias": True}
        conf["port"]["qkv_bias"] = True
    traffic = copy.deepcopy(TRAFFIC)
    if batch > 1:
        traffic["calls"] = [LENGTHS[:batch]]
    name = "tiny.batch" if batch > 1 else "tiny.single"
    return spec.Cell(name=name, chips=1, config_name="tiny", config=conf,
                     traffic_name=name, traffic=traffic, limits=dict(LIMITS),
                     end_to_end=bench["end_to_end"],
                     per_layer=[m for m in bench["per_layer"]
                                if batch > 1 or m["name"] != "lane_util_pct"])
