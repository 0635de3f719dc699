"""Phoneme vocabulary handling (the JAX package's ``data/vocab.py``).

The vocabulary is the sorted set of all space-separated phoneme tokens of a
manifest, with ``'(blank)'`` inserted at index 0 (the CTC blank). The
silence token is ``'(...)'``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

BLANK_TOKEN = "(blank)"
SIL_TOKEN = "(...)"


def build_vocab(phoneme_strings: Iterable[str]) -> Dict[str, int]:
    """Sorted token set, blank at 0."""
    tokens = set()
    for s in phoneme_strings:
        tokens.update(str(s).split())
    ordered = [BLANK_TOKEN] + sorted(tokens)
    return {tok: i for i, tok in enumerate(ordered)}


def save_vocab(vocab: Dict[str, int], path) -> None:
    Path(path).write_text(json.dumps(vocab, ensure_ascii=False))


def load_vocab(path) -> Dict[str, int]:
    return json.loads(Path(path).read_text())


def phonemes_to_ids(vocab: Dict[str, int], phonemes) -> List[int]:
    """A space-separated string (or a token list) → ids."""
    if isinstance(phonemes, str):
        phonemes = phonemes.split(" ")
    return [vocab[p] for p in phonemes]


def ids_to_phonemes(vocab: Dict[str, int], ids: Sequence[int]) -> List[str]:
    """Ids → tokens."""
    inv = {v: k for k, v in vocab.items()}
    return [inv[int(i)] for i in ids]
