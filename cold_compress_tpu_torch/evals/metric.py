"""Evaluation metrics registry.

A copy of ``cold_compress_tpu/evals/metric.py`` kept in the port (which
imports nothing of the JAX package). ``evaluate`` and ``anthropic`` are
imported only by the metrics that use them.

Mirrors the reference metric suite (reference: metric.py:12-323) with
offline-first implementations: ROUGE, accuracy, exact-match, Levenshtein
similarity, and RULER string matching are computed natively (the reference
shells out to ``evaluate``/sklearn/fuzzywuzzy, all of which want downloads);
BERTScore/BLEURT use ``evaluate`` when its models are available; the LLM-judge
metrics call the Anthropic API when a key is configured, with rate-limit
retries (reference: metric.py:157-298).
"""

from __future__ import annotations

import difflib
import os
import re
import time
from collections import Counter
from typing import Dict, List

import numpy as np


class Metric:
    def __init__(self, **kwargs):
        self._load_metric(**kwargs)

    def _load_metric(self, **kwargs):
        pass

    def compute(self, prompts, predictions, references):
        raise NotImplementedError


# --------------------------------------------------------------------------
# Lexical metrics (native)
# --------------------------------------------------------------------------


def _tokens(text: str) -> List[str]:
    return re.findall(r"[a-z0-9]+", str(text).lower())


def _ngram_f1(pred_toks, ref_toks, n: int) -> float:
    pred_ngrams = Counter(
        tuple(pred_toks[i : i + n]) for i in range(len(pred_toks) - n + 1)
    )
    ref_ngrams = Counter(
        tuple(ref_toks[i : i + n]) for i in range(len(ref_toks) - n + 1)
    )
    overlap = sum((pred_ngrams & ref_ngrams).values())
    p_total = max(sum(pred_ngrams.values()), 1)
    r_total = max(sum(ref_ngrams.values()), 1)
    p = overlap / p_total
    r = overlap / r_total
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def _lcs_len(a, b) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def _rouge_l(pred_toks, ref_toks) -> float:
    lcs = _lcs_len(pred_toks, ref_toks)
    if lcs == 0:
        return 0.0
    p = lcs / max(len(pred_toks), 1)
    r = lcs / max(len(ref_toks), 1)
    return 2 * p * r / (p + r)


class Rouge(Metric):
    """Native ROUGE-1/2/L f-measure, max over references
    (reference: metric.py:23-31 via the ``evaluate`` package)."""

    def compute(self, prompts, predictions, references):
        r1, r2, rl = [], [], []
        for pred, refs in zip(predictions, references):
            if not isinstance(refs, (list, tuple)):
                refs = [refs]
            pt = _tokens(pred)
            rts = [_tokens(r) for r in refs]
            r1.append(max(_ngram_f1(pt, rt, 1) for rt in rts))
            r2.append(max(_ngram_f1(pt, rt, 2) for rt in rts))
            rl.append(max(_rouge_l(pt, rt) for rt in rts))
        return {
            "rouge1": float(np.mean(r1)),
            "rouge2": float(np.mean(r2)),
            "rougeL": float(np.mean(rl)),
        }


class Accuracy(Metric):
    def compute(self, prompts, predictions, references):
        return float(
            np.mean([p == r for p, r in zip(predictions, references)])
        )


class ExactMatchScore(Metric):
    """Whitespace-normalized exact match (reference: metric.py:80-93)."""

    def compute(self, prompts, predictions, references):
        return float(
            np.mean(
                [
                    1 if str(p).split() == str(r).split() else 0
                    for p, r in zip(predictions, references)
                ]
            )
        )


class LevenshteinDistance(Metric):
    """Similarity ratio in [0, 100] (the reference uses fuzz.ratio,
    metric.py:96-106; difflib's ratio is the same scale)."""

    def compute(self, prompts, predictions, references):
        return float(
            np.mean(
                [
                    100.0
                    * difflib.SequenceMatcher(
                        None, str(p), str(r)
                    ).ratio()
                    for p, r in zip(predictions, references)
                ]
            )
        )


class RulerStringMatch(Metric):
    """RULER's containment scoring (reference: metric.py:109-154)."""

    def _load_metric(self, **kwargs):
        self.match_part = kwargs.get("match_part", False)

    @staticmethod
    def postprocess_pred(text: str) -> str:
        return re.sub(r"[\x00-\x1f]", "\n", str(text).strip()).strip()

    def compute(self, prompts, predictions, references):
        preds = [self.postprocess_pred(p) for p in predictions]
        scores = []
        for pred, refs in zip(preds, references):
            if not isinstance(refs, (list, tuple)):
                refs = [refs]
            hits = [1.0 if str(r).lower() in pred.lower() else 0.0 for r in refs]
            scores.append(max(hits) if self.match_part else sum(hits) / len(hits))
        return {"score": round(100.0 * sum(scores) / max(len(preds), 1), 4)}


# --------------------------------------------------------------------------
# Model-based metrics (optional heavy deps)
# --------------------------------------------------------------------------


class BertScore(Metric):
    def _load_metric(self, **kwargs):
        self.metric = None
        try:
            from evaluate import load

            self.metric = load("bertscore", keep_in_memory=True)
        except Exception as e:  # offline / missing dep
            self._error = f"bertscore unavailable: {e}"

    def compute(self, prompts, predictions, references):
        if self.metric is None:
            return {"error": self._error}
        result = self.metric.compute(
            predictions=predictions, references=references, lang="en"
        )
        return {
            "precision": float(np.mean(result["precision"])),
            "recall": float(np.mean(result["recall"])),
            "f1": float(np.mean(result["f1"])),
        }


class Bleurt(Metric):
    def _load_metric(self, **kwargs):
        self.metric = None
        try:
            from evaluate import load

            self.metric = load("bleurt", keep_in_memory=True)
        except Exception as e:
            self._error = f"bleurt unavailable: {e}"

    def compute(self, prompts, predictions, references):
        if self.metric is None:
            return {"error": self._error}
        return float(
            np.mean(
                self.metric.compute(
                    predictions=predictions, references=references
                )["scores"]
            )
        )


# --------------------------------------------------------------------------
# LLM judges via the Anthropic API (reference: metric.py:157-298)
# --------------------------------------------------------------------------

JUDGE_SIMILARITY_TEMPLATE = """Below are one or more ground-truth answers \
followed by an answer produced by a language model. Rate how well the model \
answer matches the ground truth on a 1-5 scale (5 = equivalent, 1 = unrelated). \
Reply with the number only.

====GROUND TRUTHS====
{labels}

====ANSWER====
{prediction}"""

JUDGE_PREFILL = "The score (1-5) is:"

JUDGE_CRITERIA = {
    "helpful": "The answer does what the prompt asks, without extraneous detail.",
    "coherent": "The answer is logically structured and coherent (ignore the prompt).",
    "faithful": "The answer is faithful to the prompt and contains no false information.",
}

JUDGE_SCORECARD_TEMPLATE = """Below is a prompt and an answer generated by a \
language model. Score the answer on each of the following criteria from 1-5 \
(5 = best). Respond with one "criteria: score" line per criterion.

===CRITERIA===
{criteria}

====PROMPT====
{prompt}

====ANSWER====
{prediction}"""


class LLMRouge(Metric):
    """1-5 Likert similarity judged by Claude (reference: metric.py:170-224)."""

    def __init__(self, num_retries=5, **kwargs):
        assert "ANTHROPIC_API_KEY" in os.environ, (
            "Please set the ANTHROPIC_API_KEY environment variable."
        )
        super().__init__(**kwargs)
        self.num_retries = num_retries

    def _load_metric(self, **kwargs):
        import anthropic

        self.model = kwargs.get("model", "claude-3-5-haiku-latest")
        self.client = anthropic.Anthropic()

    def _ask(self, prompt: str, prefill: str) -> str:
        import anthropic

        for attempt in range(self.num_retries + 1):
            try:
                resp = self.client.messages.create(
                    model=self.model,
                    max_tokens=64,
                    system="You are a helpful and concise assistant.",
                    messages=[
                        {"role": "user", "content": prompt},
                        {"role": "assistant", "content": prefill},
                    ],
                )
                return resp.content[0].text
            except anthropic.RateLimitError:
                if attempt == self.num_retries:
                    raise
                time.sleep(10)

    def compute(self, prompts, predictions, labels):
        scores = []
        for pred, ls in zip(predictions, labels):
            if not isinstance(ls, (list, tuple)):
                ls = [ls]
            text = self._ask(
                JUDGE_SIMILARITY_TEMPLATE.format(
                    labels="\n---\n".join(map(str, ls)), prediction=pred
                ),
                JUDGE_PREFILL,
            )
            scores.append(int(re.search(r"\d+", text).group()))
        return {"llm_rouge": sum(scores) / len(scores)}


class LLMJudge(LLMRouge):
    """Multi-criteria scorecard judge (reference: metric.py:249-298)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.criteria = sorted(JUDGE_CRITERIA)
        self.criteria_def = "\n".join(
            f"{k}: {JUDGE_CRITERIA[k]}" for k in self.criteria
        )

    def compute(self, prompts, predictions, labels):
        all_scores = []
        for prompt, pred in zip(prompts, predictions):
            prefill = f"{self.criteria[0]}:"
            text = prefill + self._ask(
                JUDGE_SCORECARD_TEMPLATE.format(
                    criteria=self.criteria_def, prompt=prompt, prediction=pred
                ),
                prefill,
            )
            pairs = re.findall(
                rf"({'|'.join(self.criteria)})\W+(\d+)", text
            )
            all_scores.append({k: int(v) for k, v in pairs})
        return {
            k: float(np.mean([s.get(k, np.nan) for s in all_scores]))
            for k in self.criteria
        }


METRIC_MAPPING = {
    "accuracy": Accuracy,
    "bertscore": BertScore,
    "bleurt": Bleurt,
    "exact_match": ExactMatchScore,
    "levenshtein": LevenshteinDistance,
    "llm-rouge": LLMRouge,
    "llm-as-a-judge": LLMJudge,
    "rouge": Rouge,
    "ruler-string-match": RulerStringMatch,
}


class AutoMetric:
    def __init__(self):
        raise EnvironmentError(
            "Instantiate metrics through AutoMetric.from_name."
        )

    @staticmethod
    def from_name(metric_name, **kwargs):
        if metric_name not in METRIC_MAPPING:
            raise ValueError(f"Invalid metric name: {metric_name}")
        return METRIC_MAPPING[metric_name](**kwargs)
