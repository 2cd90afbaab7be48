"""CLIP byte-pair-encoding tokenizer (a copy of
spider_tpu/models/clip_tokenizer.py, which the port may not import; the
vocabulary is read at run time from the standard `bpe_simple_vocab_16e6.txt.gz`
merges file that ships with CLIP / ImageBind checkpoints). It drives the SD /
SDXL / ZeroScope text encoders when real weights are used; TinyTokenizer
remains the hermetic stand-in.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from types import SimpleNamespace
from typing import Dict, List, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(self, bpe_path: str, context_length: int = 77):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # stdlib-re approximation of CLIP's \p{L}/\p{N} pattern (ASCII letters
        # + unicode word chars fall through to the catch-all group)
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)
        self.context_length = context_length

    @property
    def bos_token_id(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eos_token_id(self) -> int:
        return self.encoder["<|endoftext|>"]

    @property
    def pad_token_id(self) -> int:
        return self.eos_token_id

    def __len__(self):
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        ids: List[int] = [self.bos_token_id] if add_special_tokens else []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        if add_special_tokens:
            ids.append(self.eos_token_id)
        return ids

    def __call__(self, text, add_special_tokens: bool = True, **_kw):
        if isinstance(text, str):
            ids = self.encode(text, add_special_tokens)
            return SimpleNamespace(input_ids=ids,
                                   attention_mask=[1] * len(ids))
        batch = [self.encode(t, add_special_tokens) for t in text]
        return SimpleNamespace(input_ids=batch,
                               attention_mask=[[1] * len(b) for b in batch])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.decoder.get(int(i), "")
            if skip_special_tokens and tok in ("<|startoftext|>",
                                               "<|endoftext|>"):
                continue
            tokens.append(tok)
        text = "".join(tokens)
        data = bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()
