"""Token ids of the class prompts, worked out without the program's tokenizer.

The program tokenizes with CLIP's byte-level BPE. Without the merge table
(none ships with the repository, and the benchmark's run clears
``FMM_TPU_BPE_PATH``) it falls back to one id per byte: the printable ASCII
byte ``c`` is ``ord(c) - 33``, and the last byte of a word takes the
``</w>`` form, 256 higher. CLIP's word pattern splits letter runs, single
digits and runs of other symbols. The prompts this benchmark builds are
lowercase ASCII, so that is all this module handles.
"""

from __future__ import annotations

import re

import numpy as np

SOT, EOT = 49406, 49407
CONTEXT = 77
_WORDS = re.compile(r"[a-z]+|[0-9]|[^\sa-z0-9]+")


def encode(text: str) -> list:
    ids = []
    for word in _WORDS.findall(" ".join(text.lower().split())):
        codes = [ord(c) - 33 for c in word]
        if any(not 0 <= c < 94 for c in codes):
            raise ValueError(f"{word!r}: only printable ASCII is handled")
        codes[-1] += 256
        ids.extend(codes)
    return ids


def tokenize(texts) -> np.ndarray:
    """``(n, 77)`` int64 ids: SOT, the text, EOT, zeros."""
    out = np.zeros((len(texts), CONTEXT), np.int64)
    for i, text in enumerate(texts):
        ids = [SOT] + encode(text) + [EOT]
        if len(ids) > CONTEXT:
            raise ValueError(f"{text!r} is longer than {CONTEXT} tokens")
        out[i, :len(ids)] = ids
    return out
