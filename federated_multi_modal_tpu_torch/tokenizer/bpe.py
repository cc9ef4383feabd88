"""Byte-level BPE tokenizer with the CLIP text-encoding contract.

Behavior-equivalent rebuild of the reference tokenizer
(``clip/simple_tokenizer.py``): byte->unicode mapping, greedy lowest-rank
BPE merging with ``</w>`` end-of-word markers, the CLIP word-splitting regex
and ``<|startoftext|>``/``<|endoftext|>`` specials, and ``tokenize()``
padding to a 77-token context (``clip/clip.py:185-221``).

The official merge table (``bpe_simple_vocab_16e6.txt.gz``) is loaded when
available (path argument, ``FMM_TPU_BPE_PATH`` env var, or package-local
file).  When absent — e.g. air-gapped environments — a deterministic
byte-level fallback vocabulary is used: no merges, specials pinned at ids
49406/49407 so EOT stays the highest id in every sequence (the text encoder
pools at ``argmax(tokens)``, reference ``clip/model.py:705``).  Fallback ids
are NOT parity-compatible with OpenAI CLIP checkpoints; a warning is issued
once.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
import warnings
from functools import lru_cache
from typing import List, Union

import numpy as np

try:
    import regex as re
except ImportError as _e:  # pragma: no cover - regex is in the target env
    # stdlib `re` cannot compile the \p{L}/\p{N} unicode classes the CLIP
    # word pattern needs — fail with a clear message instead of an obscure
    # `bad escape \p` at tokenizer construction
    raise ImportError(
        "the `regex` package is required for CLIP BPE tokenization"
    ) from _e

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

VOCAB_SIZE = 49408
SOT_TOKEN = 49406
EOT_TOKEN = 49407
CONTEXT_LENGTH = 77

_WORD_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


@lru_cache()
def bytes_to_unicode():
    """Map every byte to a printable unicode char (reversible, no controls).

    Standard GPT-2/CLIP byte-level BPE alphabet: printable ASCII and two
    latin-1 ranges map to themselves; the remaining bytes map to 256+n.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean_text(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    else:
        # light-weight stand-in: normalize + fix double-encoded entities
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


def _default_bpe_path():
    env = os.environ.get("FMM_TPU_BPE_PATH")
    if env:
        return env
    local = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz"
    )
    return local


class ClipTokenizer:
    """CLIP byte-level BPE encoder/decoder."""

    def __init__(self, bpe_path: str = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        bpe_path = bpe_path or _default_bpe_path()

        merges = self._load_merges(bpe_path)
        self.fallback_mode = merges is None

        base = list(self.byte_encoder.values())
        vocab = base + [c + "</w>" for c in base]
        if merges is None:
            warnings.warn(
                "CLIP BPE merge table not found; using deterministic "
                "byte-level fallback vocabulary (token ids are NOT "
                "compatible with OpenAI CLIP checkpoints). Provide "
                "bpe_simple_vocab_16e6.txt.gz via FMM_TPU_BPE_PATH for "
                "parity.",
                stacklevel=2,
            )
            merges = []
        for merge in merges:
            vocab.append("".join(merge))
        # pad so the special tokens always land on 49406/49407
        while len(vocab) < VOCAB_SIZE - 2:
            vocab.append(f"<|unused{len(vocab)}|>")
        vocab = vocab[: VOCAB_SIZE - 2]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(_WORD_PATTERN, re.IGNORECASE)

    @staticmethod
    def _load_merges(bpe_path: str):
        if not bpe_path or not os.path.exists(bpe_path):
            return None
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # first line is a version header; table holds 49152-256-2 merges
        lines = lines[1 : VOCAB_SIZE - 512 - 2 + 1]
        return [tuple(line.split()) for line in lines if line]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)

        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _clean_text(text).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_tokenizer_singleton = None


def get_tokenizer() -> ClipTokenizer:
    global _tokenizer_singleton
    if _tokenizer_singleton is None:
        _tokenizer_singleton = ClipTokenizer()
    return _tokenizer_singleton


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """Tokenize into a fixed ``(n, context_length)`` int32 array.

    Mirrors ``clip.tokenize`` (reference ``clip/clip.py:185-221``):
    SOT + bpe(text) + EOT, zero-padded; overlong sequences raise unless
    ``truncate`` (which keeps EOT as the final token).
    """
    if isinstance(texts, str):
        texts = [texts]

    tok = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [SOT_TOKEN] + tok.encode(text) + [EOT_TOKEN]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = EOT_TOKEN
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}"
                )
        result[i, : len(tokens)] = tokens
    return result
