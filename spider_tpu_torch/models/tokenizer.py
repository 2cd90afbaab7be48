"""Spider's vocabulary extension and a byte-level tokenizer for tests and
offline use.

Copies of ``extend_tokenizer`` and ``TinyTokenizer`` from
spider_tpu/models/tokenizer.py, which is pure Python: the port needs them
without importing the JAX package. ``extend_tokenizer`` adds per-modality tag
tokens ``<X>``/``</X>``, signal tokens ``[X0]..[Xn]``, the special tokens
``[INPUT]/[OUTPUT]/[END]/[TASK]...`` and ``<Loc%d>`` bbox bins to any object
with the HF-tokenizer surface (``add_tokens`` / ``__call__`` / ``__len__``),
which ``TinyTokenizer`` provides.
"""

from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

DEFAULT_MODALITY_TOKENS = {"IMAGE": 4, "VIDEO": 24, "AUDIO": 8, "MASK": 1, "BOX": 1}
DEFAULT_SPECIAL_TOKENS = [
    "[INPUT]", "[OUTPUT]", "[END]", "[IMAGE]", "[VIDEO]", "[AUDIO]", "[BOX]",
    "[MASK]", "[SMARTMULTIMODAL]", "[SPECIFICMULTIMODAL]",
]


def extend_tokenizer(tokenizer,
                     new_modality_tokens: Optional[Dict[str, int]] = None,
                     new_special_tokens: Optional[List[str]] = None,
                     bbox_bins: int = 1000) -> Dict[str, List[int]]:
    """Add Spider's token inventory; returns {modality: [signal token ids]}."""
    if new_modality_tokens is None:
        new_modality_tokens = dict(DEFAULT_MODALITY_TOKENS)
    if new_special_tokens is None:
        new_special_tokens = list(DEFAULT_SPECIAL_TOKENS)

    new_modality_idxs: Dict[str, List[int]] = {}
    for modality, count in new_modality_tokens.items():
        tokenizer.add_tokens(f"<{modality}>")
        tokenizer.add_tokens(f"</{modality}>")
        idxs = []
        for i in range(count):
            token = f"[{modality}{i}]"
            tokenizer.add_tokens(token)
            ids = tokenizer(token, add_special_tokens=False).input_ids
            if len(ids) != 1:
                raise ValueError(f"{token} did not become one token: {ids}")
            idxs.append(ids[0])
        new_modality_idxs[modality] = idxs
    tokenizer.add_tokens(new_special_tokens)
    for i in range(bbox_bins):
        tokenizer.add_tokens(f"<Loc{i}>")
    return new_modality_idxs


class TinyTokenizer:
    """Self-contained byte-level tokenizer with HF-compatible surface.

    Base vocabulary: 3 specials (pad/bos/eos) + 256 bytes. ``add_tokens``
    appends whole-string tokens that are matched greedily (longest first)
    during encoding — the same contract HF added-tokens provide, which is all
    Spider's signal-token machinery relies on.
    """

    def __init__(self):
        self.pad_token = "<pad>"
        self.bos_token = "<s>"
        self.eos_token = "</s>"
        self._specials = [self.pad_token, self.bos_token, self.eos_token]
        self._added: Dict[str, int] = {}
        self._added_rev: Dict[int, str] = {}
        self.padding_side = "right"
        self._pattern = None

    # --- ids ---------------------------------------------------------------
    @property
    def pad_token_id(self) -> int:
        return 0

    @property
    def bos_token_id(self) -> int:
        return 1

    @property
    def eos_token_id(self) -> int:
        return 2

    def __len__(self) -> int:
        return 3 + 256 + len(self._added)

    @property
    def vocab_size(self) -> int:
        return len(self)

    # --- vocab extension -----------------------------------------------------
    def add_tokens(self, tokens) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for t in tokens:
            if t not in self._added:
                idx = 3 + 256 + len(self._added)
                self._added[t] = idx
                self._added_rev[idx] = t
                added += 1
        if added:
            self._pattern = None
        return added

    def _compiled(self):
        if self._pattern is None and self._added:
            alts = sorted(self._added, key=len, reverse=True)
            self._pattern = re.compile("|".join(re.escape(a) for a in alts))
        return self._pattern

    # --- encode / decode ------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_special_tokens else []
        pattern = self._compiled()
        pos = 0
        spans: List[Tuple[int, int, int]] = []
        if pattern:
            for m in pattern.finditer(text):
                spans.append((m.start(), m.end(), self._added[m.group()]))
        for start, end, tok_id in spans:
            ids.extend(3 + b for b in text[pos:start].encode("utf-8"))
            ids.append(tok_id)
            pos = end
        ids.extend(3 + b for b in text[pos:].encode("utf-8"))
        return ids

    def __call__(self, text, add_special_tokens: bool = True,
                 return_tensors=None, padding=False, truncation=False,
                 max_length=None):
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens)
            if truncation and max_length:
                ids = ids[:max_length]
            return SimpleNamespace(input_ids=ids,
                                   attention_mask=[1] * len(ids))
        batch = [self.encode(t, add_special_tokens) for t in text]
        if truncation and max_length:
            batch = [b[:max_length] for b in batch]
        if padding:
            longest = max(len(b) for b in batch)
            mask = [[1] * len(b) + [0] * (longest - len(b)) for b in batch]
            batch = [b + [self.pad_token_id] * (longest - len(b)) for b in batch]
        else:
            mask = [[1] * len(b) for b in batch]
        return SimpleNamespace(input_ids=batch, attention_mask=mask)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            nonlocal byte_buf
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()

        for i in ids:
            i = int(i)
            if i < 3:
                if not skip_special_tokens:
                    flush()
                    out.append(self._specials[i])
            elif i < 3 + 256:
                byte_buf.append(i - 3)
            else:
                flush()
                tok = self._added_rev.get(i, "")
                out.append(tok)
        flush()
        return "".join(out)

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._added:
            return self._added[token]
        if token in self._specials:
            return self._specials.index(token)
        ids = self.encode(token, add_special_tokens=False)
        return ids[0] if len(ids) == 1 else -1
