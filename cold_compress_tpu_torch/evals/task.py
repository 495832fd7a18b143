"""Long-context evaluation task suite.

A copy of ``cold_compress_tpu/evals/task.py`` kept in the port (which
imports nothing of the JAX package), with the same tasks, registry and
offline synthesis. One difference: the JAX package probes the HuggingFace
hub (a DNS lookup) before every task and synthesizes when it is out of
reach; here a task that has an offline synthesis (the RULER family,
LocalText, LocalCode) always synthesizes, and the others download through
``datasets`` (imported there; a missing package or network raises). So
the port reaches for the network only for a task that needs it, and
offline both give the same rows.

Mirrors the reference's 13-task harness (reference: task.py:14-786): an
``EvaluationTask`` ABC handling download, prompt templating, tokenize-and-
filter of overlong examples, and fixed-seed subsampling, plus the task zoo
(Squality, TriviaQA, Dolomites, QMSum, Musique, TruthfulQA, ScrollsQuality,
RulerQA, PG19, RulerNIAH, RulerVT, RulerCWE, RepoBench).

TPU-build addition: the RULER family is *synthesized locally* when HuggingFace
downloads are unavailable (RULER is synthetic by construction —
arXiv:2404.06654), so the eval harness runs end-to-end in air-gapped
environments. Datasets are plain lists of dicts (no ``datasets`` dependency on
the hot path).
"""

from __future__ import annotations

import random
from abc import ABC, abstractmethod
from string import ascii_uppercase
from typing import Dict, List, Optional

import numpy as np

from .metric import AutoMetric

SEP = "===="


class EvaluationTask(ABC):
    train_split = "train"
    validation_split = "validation"
    test_split = "test"
    mandatory_cols = ["context", "question", "prompt", "labels"]
    requires_logits = False
    requires_perplexity = False

    def __init__(
        self,
        prompt_template: str,
        max_tokens: int,
        model_max_length: int,
        tokenizer,  # callable: str -> list[int]
        hf_args: Optional[list] = None,
        **kwargs,
    ):
        self.prompt_template = prompt_template
        self.max_tokens = max_tokens
        self.model_max_length = model_max_length
        self.tokenizer = tokenizer
        self.hf_args = hf_args
        self.num_samples = kwargs.pop("num_samples", -1)
        self.metrics: Dict[str, object] = {}
        self._raw: Dict[str, List[dict]] = {}
        self._ready: Dict[str, List[dict]] = {}
        self._download()

    # ---- data acquisition --------------------------------------------------

    def _download(self):
        synth = self.synthesize()
        if synth is not None:
            self._raw = synth
            return
        try:
            from datasets import load_dataset

            ds = load_dataset(*self.hf_args)
            self._raw = {
                split: [dict(row) for row in ds[split]] for split in ds
            }
        except Exception as e:
            raise RuntimeError(
                f"Could not download {self.hf_args} and task has no "
                f"offline synthesis: {e}"
            ) from e

    def synthesize(self) -> Optional[Dict[str, List[dict]]]:
        """Offline fallback: return {split: [raw rows]} or None."""
        return None

    # ---- processing (reference: task.py:52-83) ------------------------------

    def get_split(self, split) -> List[dict]:
        if split not in self._ready:
            rows = []
            for raw in self._raw.get(split, []):
                out = self.prepare_row(raw)
                rows.extend(out if isinstance(out, list) else [out])
            kept = [
                r
                for r in rows
                if len(self.tokenizer(r["prompt"])) + self.max_tokens
                <= self.model_max_length
            ]
            if len(kept) < len(rows):
                print(
                    f"Filtered {len(rows) - len(kept)} examples from split "
                    f"{split}"
                )
            if 0 < self.num_samples < len(kept):
                n = self.num_samples
                # Fixed seed for reproducibility (reference: task.py:77).
                inds = random.Random(n).sample(range(len(kept)), n)
                kept = [kept[i] for i in inds]
            self._ready[split] = kept
        return self._ready[split]

    def get_train(self):
        return self.get_split(self.train_split)

    def get_validation(self):
        return self.get_split(self.validation_split)

    def get_test(self):
        return self.get_split(self.test_split)

    # ---- metrics ------------------------------------------------------------

    def compute_metrics(self, predictions, split):
        data = self.get_split(split)
        assert len(data) == len(predictions), (
            f"Number of predictions and labels must match "
            f"({len(predictions)} != {len(data)})."
        )
        prompts = [r["prompt"] for r in data]
        labels = [r["labels"] for r in data]
        return {
            name: metric.compute(prompts, predictions, labels)
            for name, metric in self.metrics.items()
        }

    def test_metrics(self, predictions):
        return self.compute_metrics(predictions, self.test_split)

    @abstractmethod
    def prepare_row(self, row: dict):
        ...


class LogitEvaluationTask(EvaluationTask):
    """MCQA via first-token probabilities (reference: task.py:142-155)."""

    requires_logits = True

    @abstractmethod
    def _process_logits(self, logits, split):
        ...

    def compute_metrics(self, predictions, split):
        predictions = self._process_logits(predictions, split)
        return super().compute_metrics(predictions, split)

    def _letter_preds(self, logits, split):
        preds = []
        for probs, row in zip(logits, self.get_split(split)):
            nc = row["num_choices"]
            scores = [probs.get(ascii_uppercase[i], 0.0) for i in range(nc)]
            preds.append(ascii_uppercase[int(np.argmax(scores))])
        return preds


# --------------------------------------------------------------------------
# Natural tasks (HF-backed; reference: task.py:158-456,726-755)
# --------------------------------------------------------------------------


class Squality(EvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You are given a story and a question. Answer the question in a "
        "single paragraph.\n\n"
        f"{SEP}STORY{SEP}\n{{story}}\n\n{SEP}QUESTION{SEP}\n{{question}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1024, **kwargs):
        super().__init__(
            prompt_template, max_tokens, hf_args=["pszemraj/SQuALITY-v1.3"], **kwargs
        )
        self.metrics = {
            "BertScore": AutoMetric.from_name("bertscore"),
            "Rouge": AutoMetric.from_name("rouge"),
            "LLM-Rouge": AutoMetric.from_name("llm-rouge"),
        }

    def prepare_row(self, row):
        story = row["document"].strip()
        out = []
        for question in row["questions"]:
            qtext = question["question_text"].strip()
            out.append(
                {
                    "prompt": self.prompt_template.format(
                        story=story, question=qtext
                    ),
                    "context": story,
                    "question": qtext,
                    "labels": [
                        resp["response_text"].strip()
                        for resp in question["responses"]
                    ],
                }
            )
        return out


class TriviaQA(EvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You are given a question and potentially relevant context from "
        "Wikipedia. Answer the question without any explanation.\n\n"
        f"{SEP}CONTEXT{SEP}\n{{context}}\n\n{SEP}QUESTION{SEP}\n{{question}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1024, **kwargs):
        self.use_web = kwargs.pop("use_web", False)
        super().__init__(
            prompt_template, max_tokens, hf_args=["trivia_qa", "rc"], **kwargs
        )
        self.metrics = {
            "BertScore": AutoMetric.from_name("bertscore"),
            "Rouge": AutoMetric.from_name("rouge"),
            "LLM-Rouge": AutoMetric.from_name("llm-rouge"),
        }

    def prepare_row(self, row):
        wikis = row["entity_pages"]
        contexts = [
            "# " + wikis["title"][i] + "\n" + wikis["wiki_context"][i]
            for i in range(len(wikis["title"]))
        ]
        if self.use_web:
            webs = row["search_results"]
            contexts += [
                f"# {webs['title'][j]}\n{webs['description'][j]}\n"
                f"{webs['search_context'][j]}"
                for j in range(len(webs["title"]))
            ]
        context_str = "\n\n".join(contexts)
        labels = list(row["answer"]["aliases"])
        if row["answer"]["value"] not in labels:
            labels.append(row["answer"]["value"])
        return {
            "context": context_str,
            "question": row["question"],
            "prompt": self.prompt_template.format(
                context=context_str, question=row["question"]
            ),
            "labels": labels,
        }


class Dolomites(EvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You need to perform a writing task from the field of {field}.\n"
        "You are given (1) a task description with input and output "
        "sections, and (2) an example input. Generate the output sections "
        "for the given example input, matching the required section headers "
        "and lengths.\n\n"
        f"{SEP}TASK DESCRIPTION{SEP}\n{{task_description}}\n\n"
        f"{SEP}EXAMPLE INPUT{SEP}\n{{example_input}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1024, **kwargs):
        super().__init__(
            prompt_template, max_tokens, hf_args=["fladhak/dolomites"], **kwargs
        )
        self.test_split = "validation"  # test split has no references
        self.metrics = {
            "BertScore": AutoMetric.from_name("bertscore"),
            "Rouge": AutoMetric.from_name("rouge"),
            "LLM-Rouge": AutoMetric.from_name("llm-rouge"),
        }

    def prepare_row(self, row):
        desc = (
            f"Task objective: {row['task_objective']}\n"
            f"Task procedure: {row['task_procedure']}\n"
            f"Task input: {row['task_input']}\n"
            f"Task output: {row['task_output']}"
        )
        if row.get("task_notes") is not None:
            desc += f"\nAdditional notes: {row['task_notes']}"
        return {
            "prompt": self.prompt_template.format(
                field=row["field"],
                task_description=desc,
                example_input=row["example_input"],
            ),
            "context": desc,
            "question": row["example_input"],
            "labels": row["example_output"],
        }


class QMSum(EvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You will be shown a meeting transcript along with a query. "
        "Carefully read the transcript and provide a concise answer to the "
        "query.\n\n"
        f"{SEP}MEETING TRANSCRIPT{SEP}\n{{transcript}}\n\n"
        f"{SEP}QUERY{SEP}\n{{query}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1024, **kwargs):
        super().__init__(
            prompt_template, max_tokens, hf_args=["fladhak/qmsum"], **kwargs
        )
        self.metrics = {
            "BertScore": AutoMetric.from_name("bertscore"),
            "Rouge": AutoMetric.from_name("rouge"),
            "LLM-Rouge": AutoMetric.from_name("llm-rouge"),
        }

    def prepare_row(self, row):
        transcript = "\n\n".join(
            f"{x['speaker']}: {x['content']}" for x in row["transcript"]
        )
        return {
            "prompt": self.prompt_template.format(
                transcript=transcript, query=row["query"]
            ),
            "context": transcript,
            "question": row["query"],
            "labels": row["answer"],
        }


class Musique(EvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You will be shown several paragraphs from Wikipedia along with a "
        "question. Carefully read the paragraphs and provide a concise "
        "answer, using only the information provided.\n\n"
        f"{SEP}PARAGRAPHS{SEP}\n{{paragraphs}}\n\n"
        f"{SEP}QUESTION{SEP}\n{{question}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=128, **kwargs):
        super().__init__(
            prompt_template, max_tokens, hf_args=["fladhak/musique"], **kwargs
        )
        self.test_split = "validation"
        self.metrics = {
            "BertScore": AutoMetric.from_name("bertscore"),
            "Rouge": AutoMetric.from_name("rouge"),
            "LLM-Rouge": AutoMetric.from_name("llm-rouge"),
        }

    def prepare_row(self, row):
        paragraphs = "\n\n".join(
            f"{x['title']}:\n{x['paragraph_text']}" for x in row["paragraphs"]
        )
        return {
            "prompt": self.prompt_template.format(
                paragraphs=paragraphs, question=row["question"]
            ),
            "context": paragraphs,
            "question": row["question"],
            "labels": [row["answer"]] + list(row["answer_aliases"]),
        }


class TruthfulQA(LogitEvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You will be shown a question with several answer choices. Pick the "
        "best answer and reply with its letter only — no explanation.\n\n"
        f"{SEP}QUESTION{SEP}\n{{question}}\n\n"
        f"{SEP}ANSWER CHOICES{SEP}\n{{choices}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1, **kwargs):
        super().__init__(
            prompt_template,
            max_tokens,
            hf_args=["truthfulqa/truthful_qa", "multiple_choice"],
            **kwargs,
        )
        self.test_split = "validation"
        self.metrics = {"Accuracy": AutoMetric.from_name("accuracy")}
        self.mandatory_cols = self.mandatory_cols + ["num_choices"]

    def prepare_row(self, row):
        choices = "\n".join(
            f"{c}. {opt}"
            for c, opt in zip(ascii_uppercase, row["mc1_targets"]["choices"])
        )
        answer = ascii_uppercase[row["mc1_targets"]["labels"].index(1)]
        return {
            "prompt": self.prompt_template.format(
                question=row["question"], choices=choices
            ),
            "question": row["question"],
            "context": choices,
            "labels": answer,
            "num_choices": len(row["mc1_targets"]["choices"]),
        }

    def _process_logits(self, logits, split):
        return self._letter_preds(logits, split)


class ScrollsQuality(LogitEvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You will be given a context, a question about it, and four answer "
        "choices. Select the best answer and reply with its letter only — "
        "no explanation.\n\n"
        f"{SEP}CONTEXT{SEP}\n{{context}}\n\n"
        f"{SEP}QUESTION{SEP}\n{{question}}\n\n"
        f"{SEP}ANSWER CHOICES{SEP}\n{{choices}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1, **kwargs):
        super().__init__(
            prompt_template, max_tokens, hf_args=["rbiswasfc/quality"], **kwargs
        )
        self.test_split = "validation"
        self.metrics = {"Accuracy": AutoMetric.from_name("accuracy")}
        self.mandatory_cols = self.mandatory_cols + ["num_choices"]

    def prepare_row(self, row):
        choices = "\n".join(
            f"{c}. {opt}" for c, opt in zip(ascii_uppercase, row["choices"])
        )
        return {
            "context": row["context"],
            "question": row["question"],
            "prompt": self.prompt_template.format(
                context=row["context"],
                question=row["question"],
                choices=choices,
            ),
            "labels": ascii_uppercase[row["label"]],
            "num_choices": len(row["choices"]),
        }

    def _process_logits(self, logits, split):
        return self._letter_preds(logits, split)


class PG19(EvaluationTask):
    """Teacher-forced perplexity over book continuations
    (reference: task.py:557-604)."""

    DEFAULT_PROMPT_TEMPLATE = (
        "You are given the title of a book and the first few words. "
        "Your job is to write it.\n\n"
        f"{SEP}TITLE{SEP}\n{{title}}\n\n"
        f"{SEP}START OF BOOK{SEP}\n{{story_start}}"
    )
    requires_perplexity = True

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, **kwargs):
        max_tokens = kwargs.pop("seq_length", None) or 8192
        super().__init__(
            prompt_template,
            max_tokens=max_tokens,
            hf_args=["emozilla/pg19-test"],
            **kwargs,
        )
        self.train_split = None
        self.validation_split = None
        self.story_snippet_size = 256

    def prepare_row(self, row):
        # Keep roughly max_tokens worth of words (~1.5 words per token).
        text = " ".join(row["text"].split(" ")[: int(self.max_tokens // 1.5)])
        toks = text.split(" ")
        start = " ".join(toks[: self.story_snippet_size])
        end = " ".join(toks[self.story_snippet_size :])
        title = row["short_book_title"]
        return {
            "context": start,
            "question": f"How would you write a book with the title: {title}",
            "prompt": self.prompt_template.format(
                title=title, story_start=start
            ),
            "labels": [end],
        }


class RepoBench(EvaluationTask):
    DEFAULT_PROMPT_TEMPLATE = (
        "You will be given python files from a code repository, with the "
        "current file shown last. Predict the next line of code in the "
        "current file — exactly one line, no explanation.\n\n"
        f"{SEP}REPOSITORY{SEP}\n{{repo}}"
    )

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=1024, **kwargs):
        super().__init__(
            prompt_template, max_tokens, hf_args=["fladhak/reprobench"], **kwargs
        )
        self.metrics = {
            "ExactMatch": AutoMetric.from_name("exact_match"),
            "Levenshtein": AutoMetric.from_name("levenshtein"),
        }

    def prepare_row(self, row):
        return {
            "prompt": self.prompt_template.format(repo=row["prompt"]),
            "context": None,
            "question": None,
            "labels": row["ref"],
        }


# --------------------------------------------------------------------------
# RULER family: HF-backed with local synthesis fallback
# (reference: task.py:518-554,607-723; synthesis per arXiv:2404.06654)
# --------------------------------------------------------------------------

_WORDS = (
    "time year people way day man thing woman life child world school state "
    "family student group country problem hand part place case week company "
    "system program question work government number night point home water "
    "room mother area money story fact month lot right study book eye job "
    "word business issue side kind head house service friend father power "
    "hour game line end member law car city community name president team "
    "minute idea body information back parent face others level office door "
    "health person art war history party result change morning reason "
    "research girl guy moment air teacher force education"
).split()

_FILLER = (
    "The sun rises over the quiet valley and the town slowly wakes. ",
    "Analysts reviewed the quarterly figures before the board meeting began. ",
    "A gentle rain fell across the orchard for most of the afternoon. ",
    "The committee postponed its decision until further data arrived. ",
    "Travelers crowded the station platform waiting for the delayed train. ",
    "New regulations changed how the factory scheduled its night shifts. ",
    "The museum unveiled a restored painting from its private collection. ",
    "Engineers tested the bridge sensors after the winter storms passed. ",
)


def _filler_text(rng: random.Random, n_sentences: int) -> List[str]:
    return [rng.choice(_FILLER) for _ in range(n_sentences)]


class _RulerBase(EvaluationTask):
    """Shared synthesis plumbing for the RULER tasks."""

    DEFAULT_PROMPT_TEMPLATE = "{task_input}"
    n_synthetic = 64
    context_sentences = 360  # ~4-5k tokens of filler

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, max_tokens=128, **kwargs):
        self.context_sentences = kwargs.pop(
            "context_sentences", self.context_sentences
        )
        # Scale the synthesized haystack to the model's context so shorter
        # models still yield usable examples instead of filtering everything
        # out. This must run BEFORE super().__init__ (which synthesizes the
        # rows), so it reads the tokenizer / context straight from kwargs.
        # Tokens-per-sentence is measured on a sample of the ACTUAL filler —
        # a fixed probe sentence under-measured it 3x and every synthesized
        # row got length-filtered (r3 eval_8b batch).
        import random as _random

        tokenize = kwargs["tokenizer"]
        sample = _filler_text(_random.Random(0), 16)
        tps = max(1, len(tokenize("".join(sample))) // len(sample))
        overhead = 8 * tps  # instructions + needles + question
        budget = kwargs["model_max_length"] - max_tokens - overhead
        if budget > 0:
            # 10% headroom: sentence lengths vary, and a row that lands a
            # few tokens over the cap is filtered outright.
            self.context_sentences = max(
                2, min(self.context_sentences, int(0.9 * budget) // tps)
            )
        super().__init__(
            prompt_template, max_tokens, hf_args=self.HF_ARGS, **kwargs
        )
        self.test_split = "validation"

    def synthesize(self):
        rows = [
            self.synthesize_row(random.Random(10_000 + i))
            for i in range(self.n_synthetic)
        ]
        return {"validation": rows}

    def prepare_row(self, row):
        task_input = row["input"]
        question = task_input.split("Question:")[-1].split("Answer:")[0].strip()
        context = task_input.split("Question:")[0].strip()
        return {
            "context": context,
            "question": question,
            "prompt": self.prompt_template.format(task_input=task_input),
            "labels": list(row["outputs"]),
        }


class RulerQA(_RulerBase):
    """RULER QA (hotpotqa-style) (reference: task.py:518-554)."""

    HF_ARGS = ["rbiswasfc/ruler", "qa_2_8k"]

    def __init__(self, prompt_template="{task_input}", max_tokens=32, **kwargs):
        super().__init__(prompt_template, max_tokens, **kwargs)
        self.metrics = {
            "StringMatch": AutoMetric.from_name(
                "ruler-string-match", match_part=True
            )
        }

    def synthesize_row(self, rng: random.Random):
        cities = ["Arden", "Bellmont", "Corvale", "Dunmore", "Eastwick",
                  "Farrow", "Glenhaven", "Halcyon"]
        people = ["Marlowe", "Quinn", "Sorel", "Tavish", "Ueda", "Vance"]
        n_para = 12
        target = rng.randrange(n_para)
        person = rng.choice(people)
        city = rng.choice(cities)
        paras = []
        for i in range(n_para):
            filler = "".join(_filler_text(rng, self.context_sentences // n_para))
            if i == target:
                fact = f"Professor {person} founded the observatory in {city}."
            else:
                fact = (
                    f"Professor {rng.choice(people)} lectured on "
                    f"{rng.choice(_WORDS)} studies."
                )
            paras.append(f"Passage {i + 1}:\n{filler}{fact}")
        question = (
            f"In which city did Professor {person} found the observatory?"
        )
        task_input = (
            "Answer the question based on the given passages. Only give me "
            "the answer and do not output any other words.\n\n"
            + "\n\n".join(paras)
            + f"\n\nQuestion: {question} Answer:"
        )
        return {"input": task_input, "outputs": [city]}


class RulerNIAH(_RulerBase):
    """RULER multi-key needle-in-a-haystack (reference: task.py:607-645)."""

    HF_ARGS = ["rbiswasfc/ruler", "niah_multikey_1_8k"]

    def __init__(self, prompt_template="{task_input}", max_tokens=128, **kwargs):
        super().__init__(prompt_template, max_tokens, **kwargs)
        self.metrics = {
            "StringMatch": AutoMetric.from_name(
                "ruler-string-match", match_part=False
            )
        }

    def synthesize_row(self, rng: random.Random):
        n_keys = 4
        keys = [
            f"{rng.choice(_WORDS)}-{rng.choice(_WORDS)}" for _ in range(n_keys)
        ]
        numbers = [rng.randint(1_000_000, 9_999_999) for _ in range(n_keys)]
        sentences = _filler_text(rng, self.context_sentences)
        for key, num in zip(keys, numbers):
            pos = rng.randrange(len(sentences))
            sentences.insert(
                pos, f"One of the special magic numbers for {key} is: {num}. "
            )
        q_idx = rng.randrange(n_keys)
        task_input = (
            "Some special magic numbers are hidden within the following "
            "text. Make sure to memorize it. I will quiz you about the "
            "numbers afterwards.\n"
            + "".join(sentences)
            + f"\nQuestion: What is the special magic number for "
            f"{keys[q_idx]} mentioned in the provided text? Answer:"
        )
        return {"input": task_input, "outputs": [str(numbers[q_idx])]}


class RulerVT(_RulerBase):
    """RULER variable tracking (reference: task.py:648-684)."""

    HF_ARGS = ["rbiswasfc/ruler", "vt_8k"]

    def __init__(self, prompt_template="{task_input}", max_tokens=30, **kwargs):
        super().__init__(prompt_template, max_tokens, **kwargs)
        self.metrics = {
            "StringMatch": AutoMetric.from_name(
                "ruler-string-match", match_part=False
            )
        }

    def synthesize_row(self, rng: random.Random):
        def var():
            return "VAR " + "".join(
                rng.choice("ABCDEFGHIJKLMNOPQRSTUVWXYZ") for _ in range(3)
            )

        n_chains, chain_len = 3, 4
        value = rng.randint(10000, 99999)
        chains = [[var() for _ in range(chain_len)] for _ in range(n_chains)]
        target = 0
        statements = []
        for ci, chain in enumerate(chains):
            v = value if ci == target else rng.randint(10000, 99999)
            statements.append(f"{chain[0]} = {v} ; ")
            statements += [
                f"{chain[j]} = {chain[j - 1]} ; " for j in range(1, chain_len)
            ]
        sentences = _filler_text(rng, self.context_sentences)
        for s in statements:
            sentences.insert(rng.randrange(len(sentences)), s)
        task_input = (
            "Memorize and track the chain(s) of variable assignment hidden "
            "in the following text.\n\n"
            + "".join(sentences)
            + f"\nQuestion: Find all variables that are assigned the value "
            f"{value} in the text above. Answer: According to the chain(s) "
            "of variable assignment in the text above, "
            f"{len(chains[target])} variables are assigned the value "
            f"{value}, they are: "
        )
        outputs = [v.split()[-1] for v in chains[target]]
        return {"input": task_input, "outputs": outputs}


class RulerCWE(_RulerBase):
    """RULER common-word extraction (reference: task.py:687-723)."""

    HF_ARGS = ["rbiswasfc/ruler", "cwe_8k"]

    def __init__(self, prompt_template="{task_input}", max_tokens=120, **kwargs):
        super().__init__(prompt_template, max_tokens, **kwargs)
        self.metrics = {
            "StringMatch": AutoMetric.from_name(
                "ruler-string-match", match_part=False
            )
        }

    def synthesize_row(self, rng: random.Random):
        words = list(_WORDS)
        rng.shuffle(words)
        common, rare = words[:10], words[10 : 10 + 300]
        pool = common * 30 + rare
        rng.shuffle(pool)
        numbered = " ".join(f"{i + 1}. {w}" for i, w in enumerate(pool))
        task_input = (
            "Below is a numbered list of words. In these words, some appear "
            "more often than others. Memorize the ones that appear most "
            "often.\n"
            + numbered
            + "\nQuestion: What are the 10 most common words in the above "
            "list? Answer: The top 10 words that appear most often in the "
            "list are:"
        )
        return {"input": task_input, "outputs": sorted(common)}


# --------------------------------------------------------------------------
# Local offline tasks: real metrics without network access
# --------------------------------------------------------------------------
#
# The HF-backed tasks cannot download their corpora in this environment, so
# these two tasks draw from the deterministic HELD-OUT bucket of the local
# text corpus (utils/local_corpus.py) — the same split whose train bucket
# produced the TinyByteLM fixture (scripts/train_tiny.py). They give the
# eval pipeline (convert -> quantize -> eval.py -> metrics) honest,
# non-degenerate numbers from trained weights: LocalText is the PG19
# analogue (teacher-forced perplexity), LocalCode the RepoBench analogue
# (next-line completion scored by ExactMatch/Levenshtein).


class LocalText(EvaluationTask):
    """Teacher-forced perplexity over held-out local text (PG19 analogue;
    reference: task.py:557-604)."""

    DEFAULT_PROMPT_TEMPLATE = "{story_start}"
    requires_perplexity = True

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE, **kwargs):
        max_tokens = kwargs.pop("seq_length", None) or 1024
        self.prompt_chars = kwargs.pop("prompt_chars", 512)
        super().__init__(
            prompt_template, max_tokens=max_tokens,
            hf_args=["__local_text__"], **kwargs,
        )
        self.train_split = None
        self.validation_split = None

    def _download(self):
        self._raw = self.synthesize()

    def synthesize(self):
        from ..utils.local_corpus import held_out_texts

        rows = []
        for text in held_out_texts(max_files=64):
            if len(text) < self.prompt_chars * 4:
                continue
            rows.append({"text": text})
        return {"test": rows}

    def prepare_row(self, row):
        text = row["text"]
        start = text[: self.prompt_chars]
        # Continuation capped near the model context (byte tokenizer:
        # chars ~ tokens).
        end = text[self.prompt_chars : self.prompt_chars + self.max_tokens * 4]
        return {
            "context": start,
            "question": "Continue the text.",
            "prompt": self.prompt_template.format(story_start=start),
            "labels": [end],
        }


class LocalCode(EvaluationTask):
    """Next-line code completion over held-out local Python files
    (RepoBench analogue; reference: task.py:726-757)."""

    DEFAULT_PROMPT_TEMPLATE = (
        "# Predict the next line of this Python file.\n\n{code}"
    )
    n_rows = 64

    def __init__(self, prompt_template=DEFAULT_PROMPT_TEMPLATE,
                 max_tokens=96, **kwargs):
        # Byte-tokenizer models: chars == tokens, so the window plus the
        # generation budget must fit the model context (2048 for TinyByteLM).
        self.window_chars = kwargs.pop("window_chars", 1536)
        super().__init__(
            prompt_template, max_tokens, hf_args=["__local_code__"], **kwargs
        )
        self.train_split = None
        self.validation_split = None
        self.metrics = {
            "ExactMatch": AutoMetric.from_name("exact_match"),
            "Levenshtein": AutoMetric.from_name("levenshtein"),
        }

    def _download(self):
        self._raw = self.synthesize()

    def synthesize(self):
        from ..utils.local_corpus import held_out_texts

        rng = random.Random(977)
        rows = []
        texts = [
            t for t in held_out_texts(max_files=96)
            if len(t) > self.window_chars * 2 and "def " in t
        ]
        # Attempts counter rotates texts on failure and bounds the loop:
        # pathological corpora (minified/single-line files) would otherwise
        # retry the same windows forever instead of yielding fewer rows.
        attempts = 0
        max_attempts = self.n_rows * 50
        while len(rows) < self.n_rows and texts and attempts < max_attempts:
            text = texts[attempts % len(texts)]
            attempts += 1
            start = rng.randrange(0, len(text) - self.window_chars - 256)
            window = text[start : start + self.window_chars]
            # Cut at a line boundary; the label is the next non-trivial line.
            cut = window.rfind("\n")
            if cut < self.window_chars // 2:
                continue
            prompt_code = window[:cut]
            rest = window[cut + 1 :].split("\n")
            label = next(
                (ln for ln in rest if len(ln.strip()) > 4), None
            )
            if label is None:
                continue
            rows.append({"code": prompt_code, "next_line": label})
        return {"test": rows}

    def prepare_row(self, row):
        return {
            "context": row["code"],
            "question": "What is the next line?",
            "prompt": self.prompt_template.format(code=row["code"]),
            "labels": [row["next_line"]],
        }


TASK_MAPPING = {
    "dolomites": Dolomites,
    "localtext": LocalText,
    "localcode": LocalCode,
    "musique": Musique,
    "pg19": PG19,
    "qmsum": QMSum,
    "repobench": RepoBench,
    "rulerqa": RulerQA,
    "rulerniah": RulerNIAH,
    "rulervt": RulerVT,
    "rulercwe": RulerCWE,
    "scrollsquality": ScrollsQuality,
    "squality": Squality,
    "triviaqa": TriviaQA,
    "truthfulqa": TruthfulQA,
}


class AutoTask:
    def __init__(self):
        raise EnvironmentError(
            "Instantiate tasks through AutoTask.from_name."
        )

    @staticmethod
    def from_name(task_name, **kwargs):
        if task_name not in TASK_MAPPING:
            raise ValueError(
                f"Task {task_name} not found. Available: "
                f"{list(TASK_MAPPING.keys())}"
            )
        return TASK_MAPPING[task_name](**kwargs)


if __name__ == "__main__":
    # Smoke harness (reference: task.py:789-901): print a sample datapoint and
    # emit per-task prompt/label token statistics to cache_configs/.
    import argparse
    import csv
    from pathlib import Path

    parser = argparse.ArgumentParser()
    parser.add_argument("--task", default="rulerniah")
    parser.add_argument("--stats", action="store_true")
    args = parser.parse_args()

    def word_tokenizer(text):
        return text.split()

    kw = dict(
        model_max_length=131072, tokenizer=word_tokenizer, num_samples=4
    )
    if args.stats:
        # Published Llama-3-tokenizer corpus statistics for the HF-hosted
        # tasks (reference: cache_configs/task_stats.csv:1-12) — they define
        # the benchmark corpora and cannot be re-measured without network
        # access; offline-synthesized tasks are measured live below.
        published = {
            "dolomites": (664, False, 780.51, 468.89, ""),
            "musique": (2417, False, 2469.28, 14.04, ""),
            "qmsum": (281, False, 14065.03, 84.61, ""),
            "rulercwe": (500, False, 3791.21, 11.92, ""),
            "rulerniah": (500, False, 3819.52, 13.0, ""),
            "rulerqa": (500, False, 3333.91, 13.74, ""),
            "rulervt": (500, False, 3847.11, 13.11, ""),
            "scrollsquality": (2086, True, 5986.95, 11.0, ""),
            "squality": (260, False, 6879.08, 283.76, ""),
            "triviaqa": (17210, False, 10643.66, 13.0, ""),
            "truthfulqa": (817, True, 152.85, 11.0, ""),
        }
        out = Path(__file__).parents[2] / "cache_configs" / "task_stats.csv"
        rows = []
        for name in TASK_MAPPING:
            try:
                task = AutoTask.from_name(name, **kw)
                test = task.get_test()
                plens = [len(word_tokenizer(r["prompt"])) for r in test]
                llens = [
                    len(word_tokenizer(r["labels"][0])) if r["labels"] else 0
                    for r in test
                ]
                rows.append(
                    {
                        "task": name,
                        "n": len(test),
                        "is_mcqa": task.requires_logits,
                        "prompt_tokens": round(float(np.mean(plens)), 2),
                        "label_tokens": round(float(np.mean(llens)), 2),
                        "n_choices": "",
                        "source": "measured_words",
                    }
                )
                print(rows[-1])
            except Exception as e:
                if name in published:
                    n, mcqa, pt, lt, nc = published[name]
                    rows.append(
                        {
                            "task": name,
                            "n": n,
                            "is_mcqa": mcqa,
                            "prompt_tokens": pt,
                            "label_tokens": lt,
                            "n_choices": nc,
                            "source": "published_llama3_tokens",
                        }
                    )
                else:
                    print(f"{name}: unavailable ({type(e).__name__})")
        rows.sort(key=lambda r: r["task"])
        with open(out, "w", newline="") as fd:
            w = csv.DictWriter(fd, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"Wrote {out}")
    else:
        task = AutoTask.from_name(args.task, **kw)
        sample = task.get_test()[0]
        print("PROMPT:\n", sample["prompt"][:2000])
        print("LABELS:", sample["labels"])
