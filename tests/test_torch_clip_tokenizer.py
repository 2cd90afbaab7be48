"""The port's copy of the CLIP BPE tokenizer (spider_tpu_torch/models/
clip_tokenizer.py) against the JAX package's original, on merges files
built here (gzipped and plain, as tests/test_llama.py builds one): the same
ids, decodes, special tokens and batch results."""

import gzip

import pytest

from spider_tpu.models import clip_tokenizer as jtok
from spider_tpu_torch.models import clip_tokenizer as ttok

MERGES = ["#version: test", "h e", "l l", "ll o</w>", "he llo</w>", "w o", "r l", "wo rl",
          "worl d</w>", "c a", "ca t</w>", "d o", "do g</w>", "a n", "an d</w>"]
TEXTS = ["hello world", "Hello   WORLD!", "a cat and a dog", "it's 42 cats &amp; dogs",
         "", "héllo wörld", "<|startoftext|>hello<|endoftext|>", "worldworld hellohello"]


@pytest.fixture(params=[".txt.gz", ".txt"])
def bpe_path(tmp_path, request):
    path = tmp_path / f"bpe{request.param}"
    opener = gzip.open if request.param.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(MERGES))
    return str(path)


def test_copy_matches_the_original(bpe_path):
    want, got = jtok.CLIPTokenizer(bpe_path), ttok.CLIPTokenizer(bpe_path)
    assert len(got) == len(want)
    assert (got.bos_token_id, got.eos_token_id, got.pad_token_id) == (
        want.bos_token_id, want.eos_token_id, want.pad_token_id)
    for text in TEXTS:
        for special in (True, False):
            ids = got(text, add_special_tokens=special).input_ids
            assert ids == want(text, add_special_tokens=special).input_ids, text
            assert got.decode(ids) == want.decode(ids)
            assert got.decode(ids, skip_special_tokens=False) == want.decode(
                ids, skip_special_tokens=False)
    batch = got(TEXTS, add_special_tokens=True)
    assert batch.input_ids == want(TEXTS, add_special_tokens=True).input_ids
    assert batch.attention_mask == [[1] * len(i) for i in batch.input_ids]
    assert len(got.encode("hello", add_special_tokens=False)) == 1      # a merged word
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
