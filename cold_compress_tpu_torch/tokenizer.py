"""Tokenizers: the byte-level tokenizer, SentencePiece / tiktoken / HF
wrappers, chat formats, and the special- and punctuation-id lists that the
FastGen hybrid cache classifies tokens by.

Port of ``cold_compress_tpu/tokenizer.py`` (a copy: the port imports nothing
of the JAX package). The wrappers import their packages (``sentencepiece``,
``tiktoken``, ``transformers``) in their constructors, so a missing package
raises there; ``ByteTokenizer`` needs none and no model file, and
``get_tokenizer`` picks it for any name containing ``byte``.
"""

from __future__ import annotations

import itertools
import os
import re
import string
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, List, Optional

_PUNC_PATTERN = re.compile(rf"^[\s{re.escape(string.punctuation)}]*$")


def is_punc_token(text: str) -> bool:
    """True for tokens made only of whitespace/punctuation."""
    return bool(_PUNC_PATTERN.match(text))


class TokenizerInterface(ABC):
    def __init__(self, model_path):
        self.model_path = model_path
        self._vocab: Optional[List[str]] = None

    @abstractmethod
    def encode(self, text: str) -> List[int]: ...

    @abstractmethod
    def decode(self, tokens: List[int]) -> str: ...

    @abstractmethod
    def bos_id(self) -> int: ...

    @abstractmethod
    def eos_id(self) -> int: ...

    @abstractmethod
    def get_terminator_ids(self) -> List[int]: ...

    @abstractmethod
    def special_ids(self) -> List[List[int]]: ...

    @abstractmethod
    def __len__(self) -> int: ...

    def punctuation_ids(self) -> List[int]:
        return [
            i for i, piece in enumerate(self.get_vocab()) if is_punc_token(piece)
        ]

    def get_vocab(self) -> List[str]:
        # Built lazily: decoding a 128k-entry vocab costs seconds of host
        # time and only punctuation_ids() (FastGen hybrid) consumes it.
        if self._vocab is None:
            self._vocab = self._build_vocab()
        return self._vocab

    def _build_vocab(self) -> List[str]:
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a vocab"
        )

    def encode_prompt(self, prompt: str) -> List[int]:
        """Chat-format a single user prompt; plain tokenizers prepend BOS."""
        return [self.bos_id()] + self.encode(prompt)


class ByteTokenizer(TokenizerInterface):
    """Dependency-free byte-level tokenizer (ids 0-255 = bytes, then BOS/EOS),
    for tests and random-weight runs where no tokenizer files exist."""

    def __init__(self, vocab_size: int = 512):
        super().__init__(None)
        self._bos = 256
        self._eos = 257
        self.vocab_size = max(vocab_size, 258)

    def _build_vocab(self) -> List[str]:
        return [chr(i) for i in range(256)] + ["<bos>", "<eos>"] + [
            f"<extra_{i}>" for i in range(self.vocab_size - 258)
        ]

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode(
            "utf-8", errors="replace"
        )

    def bos_id(self) -> int:
        return self._bos

    def eos_id(self) -> int:
        return self._eos

    def get_terminator_ids(self) -> List[int]:
        return [self._eos]

    def special_ids(self) -> List[List[int]]:
        return [[self._bos], [self._eos]]

    def __len__(self) -> int:
        return self.vocab_size


class SentencePieceWrapper(TokenizerInterface):
    """Llama-2 family."""

    def __init__(self, model_path):
        super().__init__(model_path)
        import sentencepiece as spm  # optional dependency

        self.processor = spm.SentencePieceProcessor(str(model_path))
        self.terminator_ids = [self.processor.eos_id()]

    def _build_vocab(self) -> List[str]:
        return [
            self.processor.id_to_piece(i)
            for i in range(self.processor.get_piece_size())
        ]

    def _addl_special_ids(self) -> List[List[int]]:
        if "llama-2" in str(self.model_path).lower():
            extra = ["[INST]", "[/INST]"]
        else:
            raise ValueError(f"Unknown model path: {self.model_path}")
        return [self.processor.EncodeAsIds(t) for t in extra]

    def special_ids(self) -> List[List[int]]:
        return [
            [self.processor.bos_id()],
            [self.processor.eos_id()],
            *self._addl_special_ids(),
        ]

    def encode(self, text):
        return self.processor.EncodeAsIds(text)

    def decode(self, tokens):
        return self.processor.DecodeIds(list(map(int, tokens)))

    def bos_id(self):
        return self.processor.bos_id()

    def eos_id(self):
        return self.processor.eos_id()

    def get_terminator_ids(self):
        return self.terminator_ids

    def __len__(self):
        return self.processor.get_piece_size()


class TiktokenWrapper(TokenizerInterface):
    """Llama-3 family BPE with its reserved special-token table."""

    num_reserved_special_tokens = 256
    pat_str = r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"  # noqa: E501

    def __init__(self, model_path):
        super().__init__(model_path)
        import tiktoken
        from tiktoken.load import load_tiktoken_bpe

        assert os.path.isfile(model_path), str(model_path)
        mergeable_ranks = load_tiktoken_bpe(str(model_path))
        num_base = len(mergeable_ranks)
        names = [
            "<|begin_of_text|>",
            "<|end_of_text|>",
            "<|reserved_special_token_0|>",
            "<|reserved_special_token_1|>",
            "<|reserved_special_token_2|>",
            "<|reserved_special_token_3|>",
            "<|start_header_id|>",
            "<|end_header_id|>",
            "<|reserved_special_token_4|>",
            "<|eot_id|>",
        ] + [
            f"<|reserved_special_token_{i}|>"
            for i in range(5, self.num_reserved_special_tokens - 5)
        ]
        self.special_tokens: Dict[str, int] = {
            name: num_base + i for i, name in enumerate(names)
        }
        self.model = tiktoken.Encoding(
            name=Path(model_path).name,
            pat_str=self.pat_str,
            mergeable_ranks=mergeable_ranks,
            special_tokens=self.special_tokens,
        )
        self._bos_id = self.special_tokens["<|begin_of_text|>"]
        self._eos_id = self.special_tokens["<|end_of_text|>"]
        self.terminator_ids = [
            self._eos_id,
            self.special_tokens["<|eot_id|>"],
        ]

    def _build_vocab(self) -> List[str]:
        return [self.model.decode([i]) for i in range(self.model.n_vocab)]

    def encode(self, text):
        return self.model.encode(text)

    def decode(self, tokens):
        return self.model.decode(list(map(int, tokens)))

    def special_ids(self) -> List[List[int]]:
        return [[x] for x in sorted(self.special_tokens.values())]

    def bos_id(self):
        return self._bos_id

    def eos_id(self):
        return self._eos_id

    def get_terminator_ids(self):
        return self.terminator_ids

    def __len__(self):
        return self.model.n_vocab


class TokenizersWrapper(TokenizerInterface):
    """HF AutoTokenizer wrapper — Qwen2 etc.."""

    def __init__(self, model_path):
        super().__init__(model_path)
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.terminator_ids = [self.tokenizer.eos_token_id]

    def _build_vocab(self) -> List[str]:
        return [
            self.tokenizer.decode(i) for i in range(self.tokenizer.vocab_size)
        ]

    def special_ids(self) -> List[List[int]]:
        if hasattr(self.tokenizer, "special_token_ids"):
            return [[x] for x in self.tokenizer.special_token_ids]
        flat = []
        for t in self.tokenizer.special_tokens_map.values():
            flat.extend(t if isinstance(t, list) else [t])
        return [
            [self.tokenizer.convert_tokens_to_ids(t)] for t in set(flat)
        ]

    def encode(self, text):
        return self.tokenizer.encode(text, add_special_tokens=False)

    def decode(self, tokens):
        return self.tokenizer.decode(list(map(int, tokens)))

    def bos_id(self):
        return self.tokenizer.bos_token_id

    def eos_id(self):
        return self.tokenizer.eos_token_id

    def get_terminator_ids(self):
        return self.terminator_ids

    def __len__(self):
        return len(self.tokenizer)


# --------------------------------------------------------------------------
# Chat formats
# --------------------------------------------------------------------------


class Llama3ChatFormat(TiktokenWrapper):
    def encode_header(self, message) -> List[int]:
        return [
            self.special_tokens["<|start_header_id|>"],
            *self.encode(message["role"]),
            self.special_tokens["<|end_header_id|>"],
            *self.encode("\n\n"),
        ]

    def encode_message(self, message) -> List[int]:
        tokens = self.encode_header(message)
        tokens.extend(self.encode(message["content"].strip()))
        tokens.append(self.special_tokens["<|eot_id|>"])
        return tokens

    def encode_prompt(self, prompt: str) -> List[int]:
        return self.encode_dialog_prompt([{"role": "user", "content": prompt}])

    def encode_dialog_prompt(self, dialog) -> List[int]:
        return [
            self.special_tokens["<|begin_of_text|>"],
            *itertools.chain(*map(self.encode_message, dialog)),
            *self.encode_header({"role": "assistant", "content": ""}),
        ]


class Llama2ChatFormat(SentencePieceWrapper):
    B_INST = "[INST]"
    E_INST = "[/INST]"

    def encode_prompt(self, prompt: str) -> List[int]:
        ids = [self.bos_id()]
        ids += self.encode(self.B_INST + "\n\n")
        ids += self.encode(prompt + " " + self.E_INST)
        return ids


class TokenizersChatFormat(TokenizersWrapper):
    def encode_prompt(self, prompt: str) -> List[int]:
        return self.encode_dialog_prompt(
            [{"role": "user", "content": prompt}]
        )

    def encode_dialog_prompt(self, dialog) -> List[int]:
        text = self.tokenizer.apply_chat_template(
            dialog, tokenize=False, add_generation_prompt=True
        )
        return self.encode(text)


def get_tokenizer(tokenizer_model_path, model_name, is_chat=False):
    """Factory keyed on model-family name;
    ``byte`` model names map to the dependency-free byte tokenizer."""
    name = str(model_name).lower()
    if "byte" in name or "testtiny" in name.replace("-", ""):
        return ByteTokenizer()
    if "llama-3" in name:
        return (
            Llama3ChatFormat(tokenizer_model_path)
            if is_chat
            else TiktokenWrapper(tokenizer_model_path)
        )
    if "llama-2" in name:
        return (
            Llama2ChatFormat(tokenizer_model_path)
            if is_chat
            else SentencePieceWrapper(tokenizer_model_path)
        )
    return (
        TokenizersChatFormat(tokenizer_model_path)
        if is_chat
        else TokenizersWrapper(tokenizer_model_path)
    )


def encode(tokenizer, prompt: str, bos: bool = True, is_chat: bool = True):
    """Encode a prompt to a python list of ids."""
    if is_chat:
        return list(tokenizer.encode_prompt(prompt))
    tokens = tokenizer.encode(prompt)
    return ([tokenizer.bos_id()] + tokens) if bos else list(tokens)
