"""Where the port and the benchmark's reference part on Mellum2 at full size:
per layer, the share of expert picks (token, expert) on which they agree,
the hidden state's gap, and the checked layer's K and V rows' gap per
position, after a prefill of the same prompts (one lane each) from the same
seeded weights.

    PYTHONPATH=. python3 scripts/torch_mellum2_agree.py --seed 1 --lengths 8064 16256 \
        --layers 4 --out mellum2_agree.json

Needs a card. The program runs first (its routing and each layer's output
recorded on the host), is freed, then the reference runs the same prompts.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from cold_compress_tpu_torch.caches import materialize_kv
from cold_compress_tpu_torch.models import transformer
from cold_compress_tpu_torch.runtime import engine, generate as gen
from portbench import spec
from portbench.reference import mellum2 as ref_mod
from portbench.reference.model import tf32

CELL = "mellum2_12b_a2p5b.repobench_8k_16k_b4"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--lengths", type=int, nargs="+", default=[8064, 16256])
    ap.add_argument("--layers", type=int, default=4, help="layers compared (from the first)")
    ap.add_argument("--out")
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU tests' tiny Mellum2 on the CPU (a rehearsal)")
    args = ap.parse_args()
    if args.tiny:
        from portbench.tests import tiny_mellum2

        cell, dev = tiny_mellum2.cell(), torch.device("cpu")
    else:
        cell, dev = spec.load_cell(CELL), torch.device("cuda")
    arch, d = cell.arch, cell.dims
    cfg = arch.port_config(cell)
    g = torch.Generator().manual_seed(args.seed)
    prompts = [torch.randint(5, d.vocab - 5, (n,), generator=g).tolist() for n in args.lengths]

    picks, states = {}, {}
    real_route, real_block = transformer.route, transformer._block

    def route(moe, x):
        ids, w = real_route(moe, x)
        if moe.layer < args.layers:
            picks.setdefault(("program", moe.layer), []).append(ids.cpu())
        return ids, w

    def block(cfg_, layer, x, attn_out, tp=None, prefill=False):
        out = real_block(cfg_, layer, x, attn_out, tp, prefill)
        li = getattr(getattr(layer, "moe", None), "layer", None)
        if li is not None and li < args.layers:
            states.setdefault(("program", li), []).append(out[0].float().cpu())
        return out

    transformer.route, transformer._block = route, block
    n_pos = gen.bucket_length(max(args.lengths))
    model = engine.build_model(cfg, arch.make_weights(d, args.seed, dev), dev, max_positions=n_pos)
    specs = engine.build_cache_specs(cfg, arch.cache_kwargs(cell.traffic["cache"], cfg), n_pos)
    caches = transformer.init_caches(cfg, specs, 1, device=dev)
    checked = arch.checked_layer(d)
    prog_rows = []
    for p in prompts:
        gen.reset_caches(caches)
        toks = torch.zeros((1, gen.bucket_length(len(p))), dtype=torch.long, device=dev)
        toks[0, :len(p)] = torch.tensor(p, device=dev)
        with torch.no_grad():
            transformer.prefill(model, caches, toks, len(p))
        k, v = materialize_kv(caches[checked], torch.float32)
        prog_rows.append({"pos": caches[checked].pos[0].cpu(), "k": k[0].cpu(), "v": v[0].cpu()})
    transformer.route, transformer._block = real_route, real_block
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()

    real_ref_route = ref_mod.Reference._route
    real_ffn = ref_mod.Reference._ffn

    def ref_route(self, L, h):
        ids, w = real_ref_route(self, L, h)
        li = next(i for i, x in enumerate(self.layers) if x is L)
        if li < args.layers:
            picks.setdefault(("reference", li), []).append(ids.cpu())
        return ids, w

    def ref_ffn(self, L, x, bits):
        y = real_ffn(self, L, x, bits)
        li = next(i for i, x_ in enumerate(self.layers) if x_ is L)
        if li < args.layers:
            states.setdefault(("reference", li), []).append((x + y).float().cpu())
        return y

    ref_mod.Reference._route, ref_mod.Reference._ffn = ref_route, ref_ffn
    report = {"seed": args.seed, "lengths": args.lengths,
              "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "layers": []}
    with tf32():
        ref = arch.Reference(d, arch.make_weights(d, args.seed, dev), cell.traffic["cache"],
                             checked=checked)
        ref_rows = []
        for p in prompts:
            _, st, rows = ref.prefill(p)
            ref_rows.append(rows)
    for li in range(args.layers):
        agree = total = 0
        hid, flips, toks = [], [], []
        for b, p in enumerate(prompts):
            a = picks[("program", li)][b][:len(p)]
            r = picks[("reference", li)][b]
            agree += (a[:, :, None] == r[:, None, :]).any(-1).sum().item()
            total += r.numel()
            xa, xr = states[("program", li)][b][:len(p)], states[("reference", li)][b]
            hid.append(float(((xa - xr) ** 2).sum().sqrt() / (xr ** 2).sum().sqrt()))
            flips.append((a.sort(-1).values != r.sort(-1).values).any(-1))
            toks.append(((xa - xr) ** 2).sum(-1).sqrt() / (xr ** 2).sum(-1).sqrt())
        flipped, tok = torch.cat(flips), torch.cat(toks)
        report["layers"].append({
            "layer": li, "kind": d.layer_types[li], "picks_agree": agree / total,
            "tokens_with_another_pick": int(flipped.sum()), "tokens": int(flipped.numel()),
            "hidden_rel_rms": hid,
            "hidden_rel_per_token_p50_p99_max": [float(tok.quantile(0.5)),
                                                 float(tok.quantile(0.99)), float(tok.max())],
            "hidden_rel_max_where_picks_agree": float(tok[~flipped].max())
            if bool((~flipped).any()) else None})
    # the checked layer's K and V rows of every position the program kept
    for b, p in enumerate(prompts):
        pr, (kr, vr) = prog_rows[b], ref_rows[b]
        pos = pr["pos"].long()
        held = pos >= 0
        h = torch.arange(pos.shape[0])[:, None].expand_as(pos)[held]
        errs = []
        for got, want in ((pr["k"], kr.cpu()), (pr["v"], vr.cpu())):
            w = want[pos[held], h]
            errs.append((((got[held] - w) ** 2).sum(-1).sqrt() / (w ** 2).sum(-1).sqrt()))
        e = torch.maximum(*errs)
        report.setdefault("checked_rows", []).append({
            "length": len(p), "rel_p50": float(e.quantile(0.5)), "rel_p99": float(e.quantile(0.99)),
            "rel_max": float(e.max()), "share_over_5pct": float((e > 0.05).float().mean())})
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
