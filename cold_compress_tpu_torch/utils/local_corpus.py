"""Deterministic local text corpus with a train/held-out split.

A copy of ``cold_compress_tpu/utils/local_corpus.py`` kept in the port,
reading the same files: the installed numpy's and jax's sources are found
beside the imported numpy (read as text; nothing is imported from them).

The offline environment cannot download benchmark corpora or trained
checkpoints, so the trained-fixture pipeline (scripts/train_tiny.py) and the
Local* evaluation tasks (evals/task.py) share this corpus: locally available
program text and license prose, split by a stable filename hash. Bucket 0 of
16 is HELD OUT — never used for training — so task metrics measured on it are
honest generalization numbers, not memorization.
"""

import hashlib
from pathlib import Path
from typing import List, Tuple

import numpy as np

_SITE_PACKAGES = Path(np.__file__).parent.parent
_ROOTS = [
    (Path("/usr/lib/python3.11"), "*.py"),
    (Path("/usr/share/common-licenses"), "*"),
    (_SITE_PACKAGES / "numpy", "*.py"),
    (_SITE_PACKAGES / "jax", "*.py"),
]


def corpus_files() -> List[Path]:
    """Sorted list of candidate text files (stable ordering)."""
    files: List[Path] = []
    for root, pat in _ROOTS:
        if root.exists():
            files += [f for f in sorted(root.rglob(pat)) if f.is_file()]
    return files


def held_out(f: Path) -> bool:
    """True for eval-only files (hash bucket 0 of 16 on the file NAME)."""
    return hashlib.sha1(f.name.encode()).digest()[0] % 16 == 0


def load_split(max_mb: float = 24.0) -> Tuple[List[bytes], List[bytes]]:
    """(train_texts, held_out_texts) as raw bytes per file."""
    train, val = [], []
    budget = int(max_mb * 1e6)
    for f in corpus_files():
        try:
            data = f.read_bytes()
        except OSError:
            continue
        if not (256 < len(data) < 2_000_000):
            continue
        if held_out(f):
            # Held-out files are eval material: exempt from the train
            # budget so the cap can't starve evals of material.
            val.append(data)
            continue
        # Enforce the cap BEFORE appending so the corpus cannot overshoot
        # max_mb by up to one ~2MB file; keep scanning (a smaller later
        # file may still fit, and held-out files must still be collected).
        if budget - len(data) < 0:
            continue
        train.append(data)
        budget -= len(data)
    return train, val


def held_out_texts(max_files: int = 200) -> List[str]:
    """Held-out files decoded to str, longest first (eval material)."""
    _, val = load_split()
    texts = [b.decode("utf-8", errors="replace") for b in val]
    texts.sort(key=len, reverse=True)
    return texts[:max_files]
