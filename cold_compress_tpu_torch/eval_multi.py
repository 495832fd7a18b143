"""Hyper-parameter sweep of the port: ``eval.main`` re-run over a grid.

Counterpart of the repository's ``eval_multi.py``: the same ``HPARAMS``
and flags (``eval``'s, plus ``--hparam``); each value gets its own results
directory.

    python -m cold_compress_tpu_torch.eval_multi --hparam max_cache_length \\
        --tasks rulerniah --cache_strategy heavy_hitter \\
        --prompt_compression_strategy heavy_hitter --checkpoint_path <model.npz>
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import eval as port_eval

HPARAMS = {
    "max_cache_length": [[8192], [4096], [2048], [1024], [512], [256], [128]],
    "min_recovery_frac": [0.5, 0.6, 0.7, 0.8, 0.9, 0.95],
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = port_eval.build_parser(
        "Sweep a hyper-parameter for a KV-cache compression algorithm.")
    parser.add_argument("--hparam", default="max_cache_length",
                        help="The hyper-parameter to sweep.")
    args = port_eval.parse_args(argv, parser)
    if args.hparam not in HPARAMS:
        raise ValueError(f"Set {args.hparam} in the HPARAMS dictionary first.")
    for v in HPARAMS[args.hparam]:
        exp_args = argparse.Namespace(**vars(args))
        print(f"Setting {args.hparam} to {v}")
        setattr(exp_args, args.hparam, v)
        out_dir = port_eval.setup(exp_args)
        port_eval.main(exp_args, out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
