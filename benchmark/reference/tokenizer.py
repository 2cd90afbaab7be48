"""The byte-level tokenizer the configurations assume (no vocabulary file is
at hand): id 1 opens, each UTF-8 byte b is 3 + b, id 2 closes and pads, to
the text encoder's 77 positions."""

from __future__ import annotations

from typing import List, Sequence

BOS, EOS = 1, 2


def token_ids(prompt: str, length: int = 77) -> List[int]:
    ids = ([BOS] + [3 + b for b in prompt.encode("utf-8")])[:length - 1] + [EOS]
    return ids + [EOS] * (length - len(ids))


def batch_ids(prompts: Sequence[str], length: int = 77) -> List[List[int]]:
    return [token_ids(p, length) for p in prompts]
