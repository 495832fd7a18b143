"""What decides ``correct``: the served tokens and the cache against the
plain reference.

Once the window has closed and the program's state is freed, a sample of the
finished requests (lanes) is run through the architecture's reference
(``Reference`` of the module ``arch/`` names; ``reference/model.py`` for
``dense``) at the configuration's stated precisions: the prompt prefilled
and compressed by SnapKV, then every served token fed back, through the
evicting cache. The sample holds the lanes of the last call served, whose
checked layer's cache the run kept (the architecture's ``checked_layer``),
the lane that served the most tokens (the longest prompt among those), and
lanes in an order drawn from the seed.

Two numbers are compared, each with its limit in the cell's
``limits/<workload>.json``. Both read the checked layer's cache of the last
call, against the reference's own layer over the same prompt and served
tokens: ``kv_rel_err_l0``, the relative root-mean-square gap between the K
and V rows the program's cache holds and those the stated cache holds for
the same positions, and ``pos_miss_l0``, the share of the positions the
reference keeps (SnapKV, then every eviction) that the program's cache
lacks. In ``dense`` the checked layer is the first, whose rows depend on no
earlier layer, so two sound programs agree there to the last place; deeper,
random weights carry a difference of summation order to whole steps of the
int8 quantizers (PERF.md). So the served tokens' numbers are printed, not
compared: ``mean_logp_err`` and ``max_logp_err``, the mean and widest
``|log p_program - log p_reference|`` of the served tokens (``p_program``
from ``emitted_probs``), ``max_logit_gap``, how far a served token's logit
lies below the reference's best, and ``first_prob_rel_err``, prefill's
alone.

With ``control``, the control's readings come too: the reference one step
below every precision the configuration states (``Reference.control``), read
at the same prompts and served tokens, and a diagnosis: where the widest gaps
lie, and the share of the last call's cached positions that program and
reference both hold in every layer. The program's own control, its 4-bit
cache and int8 prefill activations held to this same reference at the
stated precisions, is a run of the program
(``run.run_cell(program_control=True)``, ``calibrate.py``).
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.model import tf32


def sample(records: List[dict], doc: dict, seed: int) -> List[dict]:
    """The lanes to check, each ``{"prompt", "served", "probs",
    "checked_cache"}`` (``checked_cache``: the program's cache of the checked
    layer, for the last call's lanes that ran all its steps; else None): the
    last call's lanes, the lane that served most (the longest prompt among
    those), then lanes in an order drawn from the seed until ``min_tokens``
    served tokens or ``max_lanes``."""
    lanes = []
    for i, r in enumerate(records):
        for b in range(len(r["lens"])):
            whole = len(r["served"][b]) == r["steps"] + 1
            lanes.append({"prompt": r["prompts"][b], "served": r["served"][b],
                          "probs": r["probs"][b], "last": i == len(records) - 1,
                          "checked_cache": (r["checked_cache"][b]
                                            if "checked_cache" in r and whole else None)})
    last = [i for i, lane in enumerate(lanes) if lane["last"]]
    longest = max(range(len(lanes)),
                  key=lambda i: (len(lanes[i]["served"]), len(lanes[i]["prompt"])))
    order = last + [longest] + [int(i) for i in np.random.default_rng([int(seed), 1])
                                .permutation(len(lanes))]
    out, seen, tokens = [], set(), 0
    for i in order:
        if i in seen:
            continue
        if len(out) > len(last) and (tokens >= int(doc["min_tokens"])
                                     or len(out) >= int(doc["max_lanes"])):
            break
        seen.add(i)
        out.append(lanes[i])
        tokens += len(lanes[i]["served"])
    return out


#: Every number ``readings`` gives, in the order the run prints them.
READINGS = ("kv_rel_err_l0", "pos_miss_l0", "mean_logp_err", "max_logp_err", "max_logit_gap",
            "first_prob_rel_err")


def logp_errs(probs, ref_logp) -> List[List[float]]:
    """Per lane and served position, ``|log p_program - log p_reference|``
    of the served token."""
    return [[abs(math.log(max(p, 1e-30)) - q) for p, q in zip(lane_p, lane_q)]
            for lane_p, lane_q in zip(probs, ref_logp)]


def readings(probs, r) -> Dict[str, float]:
    """Every number the check can compare, from the program's served
    tokens' probabilities and the reference's reading of them: the mean and
    the widest log-probability gap, the widest logit gap below the
    reference's best, and the widest relative gap of the first token's
    probability (prefill's alone)."""
    dl = [e for lane in logp_errs(probs, r["logp"]) for e in lane]
    return {"mean_logp_err": sum(dl) / len(dl),
            "max_logp_err": max(dl),
            "max_logit_gap": max(max(g) for g in r["gap"]),
            "first_prob_rel_err": max(abs(lane_p[0] / math.exp(lane_q[0]) - 1.0)
                                      for lane_p, lane_q in zip(probs, r["logp"]))}


def checked_readings(cands: List[Optional[dict]], r: dict) -> Dict[str, float]:
    """The checked layer's numbers, the worst over the lanes with a cache
    to read (``cands``, one per lane or None): ``kv_rel_err_l0``, the gap
    between the K and V rows a cache holds and the stated cache's rows for
    the same positions (``r["checked_kv"]``), and ``pos_miss_l0``, the share
    of the positions the reference keeps (``r["checked_cache"]``) that the
    cache lacks."""
    kv, miss = [], []
    for cand, rows, ref in zip(cands, r["checked_kv"], r["checked_cache"]):
        if cand is None:
            continue
        pos = cand["pos"].long()
        held = (pos >= 0) & (pos < rows[0].shape[0])
        h = torch.arange(pos.shape[0])[:, None].expand_as(pos)[held]
        diff = num = 0.0
        for got, want in zip((cand["k"], cand["v"]), rows):
            w = want[pos[held], h]
            diff += float(((got[held] - w) ** 2).sum())
            num += float((w ** 2).sum())
        kv.append(math.sqrt(diff / num))
        lacks = [len(set(b) - {-1} - set(a)) / max(len(set(b) - {-1}), 1)
                 for a, b in zip(pos.tolist(), ref["pos"].long().tolist())]
        miss.append(sum(lacks) / len(lacks))
    if not kv:
        return {"kv_rel_err_l0": float("nan"), "pos_miss_l0": float("nan")}
    return {"kv_rel_err_l0": max(kv), "pos_miss_l0": max(miss)}


def worst(picked, probs, r) -> dict:
    """Where the widest logit gap and the widest log-probability gap lie:
    [value, the lane's prompt length, the served position]."""
    def at(rows):
        v, b, i = max((v, b, i) for b, lane in enumerate(rows) for i, v in enumerate(lane))
        return [v, len(picked[b]["prompt"]), i]
    return {"gap": at(r["gap"]), "logp": at(logp_errs(probs, r["logp"]))}


def kept_overlap(program_pos, ref_pos) -> list:
    """The share of cached positions that the program and the reference
    both hold at the end of a call: mean and least over layers, lanes and
    KV heads."""
    shares = []
    for a, b in zip(program_pos, ref_pos):
        for x, y in zip(a.reshape(-1, a.shape[-1]).tolist(), b.reshape(-1, b.shape[-1]).tolist()):
            shares.append(len(set(x) & set(y)) / len(x))
    return [sum(shares) / len(shares), min(shares)]


def judge(cell, records: List[dict], seed: int, device, control: bool = False) -> Dict:
    """The numbers compared, each with its limit, and whether all hold.
    With ``control``, also the control's reading on the same sample."""
    picked = sample(records, cell.traffic["check"], seed)
    prompts = [lane["prompt"] for lane in picked]
    served = [lane["served"] for lane in picked]
    probs = [lane["probs"] for lane in picked]
    arch, d = cell.arch, cell.dims
    with tf32():
        ref = arch.Reference(d, arch.make_weights(d, seed, device), cell.traffic["cache"],
                             checked=arch.checked_layer(d))
        gc.collect()
        r = ref.follow(prompts, served)
        out = {**checked_readings([lane["checked_cache"] for lane in picked], r),
               **readings(probs, r), "lanes": len(picked),
               "tokens": sum(len(s) for s in served)}
        if control:
            ref.control()
            c = ref.follow(prompts, served)
            ref.control(False)
            cr = readings([[math.exp(x) for x in lane] for lane in c["logp"]], r)
            cr.update(checked_readings([c0 if lane["checked_cache"] is not None else None
                                        for c0, lane in zip(c["checked_cache"], picked)], r))
            out.update({f"control_{k}": v for k, v in cr.items() if k != "max_logit_gap"})
            # the gap of the token the control puts first, read by the reference
            c = ref.follow(prompts, served, choices=c["top"])
            out["control_max_logit_gap"] = max(max(g) for g in c["gap"])
            out["worst"] = worst(picked, probs, r)
            last = records[-1]
            f = ref.follow(last["prompts"], last["served"])
            out["kept_overlap"] = kept_overlap(last["cache_pos"], f["pos"])
    del ref, r
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out["checks"] = {k: {"value": out[k], "limit": float(v)} for k, v in cell.limits.items()}
    out["correct"] = all(c["value"] <= c["limit"] for c in out["checks"].values())
    return out
