"""The port's r1_llama3_8B entry twins on --device cpu: the infer twin held
to the JAX package's root script on the same checkpoint, the chat twin to the
port's generate, the gradio twin's server to the greedy chat.

A tiny Llama checkpoint directory (llama_tiny widths, random weights from a
seed, no tokenizer files) is what SPIDER_TPU_LLM_CKPT names; both packages
load it unquantised and decode greedily with TinyTokenizer (the JAX loader's
tokenizer is pinned to it, since the directory has no tokenizer files).
"""

import json
import os
import sys
import urllib.request

import pytest
import torch

from spider_tpu_torch.models import checkpoint_io as io
from spider_tpu_torch.models import convert as C
from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models.factory import build_llama
from spider_tpu_torch.models.tokenizer import TinyTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("r1"))
    cfg = L.llama_tiny(vocab_size=512)
    model = build_llama(cfg, "cpu", seed=5)
    hf = C.export_state_dict(C.llama_rules({"lm_head.weight"}, cfg), model.state_dict())
    io.save_file(hf, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(model_type="llama", vocab_size=512, hidden_size=cfg.hidden_size,
                       intermediate_size=cfg.intermediate_size,
                       num_hidden_layers=cfg.num_hidden_layers,
                       num_attention_heads=cfg.num_attention_heads,
                       num_key_value_heads=cfg.num_key_value_heads,
                       max_position_embeddings=cfg.max_position_embeddings,
                       rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                       tie_word_embeddings=False, torch_dtype="float32"), f)
    return path


@pytest.fixture
def jax_tiny_tokenizer(monkeypatch):
    from spider_tpu.models import tokenizer as jtok

    monkeypatch.setattr(jtok, "load_tokenizer", lambda path: jtok.TinyTokenizer())


def _root_script(name):
    sys.path.insert(0, ROOT)
    try:
        return __import__(name)
    finally:
        sys.path.remove(ROOT)


def test_infer_twin_matches_the_root_script(ckpt_dir, monkeypatch, jax_tiny_tokenizer, capsys):
    from spider_tpu_torch import r1_llama3_8B_infer as twin

    monkeypatch.setenv("SPIDER_TPU_LLM_CKPT", ckpt_dir)
    reply = twin.main(["Hello there", "--device", "cpu"])
    assert capsys.readouterr().out == reply + "\n"
    want = _root_script("r1_llama3_8B_infer").build_r1()("Hello there")
    assert reply == want and len(reply) > 0


def test_infer_twin_random_weights_and_the_card_default(monkeypatch):
    from spider_tpu_torch import r1_llama3_8B_infer as twin
    from spider_tpu_torch.models.serving_utils import load_or_init_llm
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    monkeypatch.delenv("SPIDER_TPU_LLM_CKPT", raising=False)
    reply = twin.build_r1(device="cpu")("Hi")
    model, tok = load_or_init_llm(device="cpu")
    assert isinstance(tok, TinyTokenizer) and model.config.num_hidden_layers == 2
    assert reply == make_llama_chat_fn(model, tok, max_new_tokens=64)("Hi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main(["Hi"])                    # cuda is the default: it never falls back


def test_chat_twin_streams_the_greedy_replies(ckpt_dir, monkeypatch, capsys):
    # The REPL's printed stream, turn by turn, against the port's generate
    # over the same history (stream_generate equals generate up to its eos).
    # Over 256 random-weight bf16 tokens the two packages part at near-ties,
    # so the root script is held to the infer twin's 64 tokens above.
    from spider_tpu_torch import r1_llama3_8B_chat as twin
    from spider_tpu_torch.models.decode import GenerateConfig, generate
    from spider_tpu_torch.models.serving_utils import load_or_init_llm

    monkeypatch.setenv("SPIDER_TPU_LLM_CKPT", ckpt_dir)
    monkeypatch.setattr(twin, "MAX_NEW_TOKENS", 40)       # a shorter test
    turns = iter(["Hello", "And then?", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(turns))
    history = twin.main(["--device", "cpu"])
    printed = capsys.readouterr().out

    model, tok = load_or_init_llm(ckpt_dir, device="cpu")
    cfg = GenerateConfig(max_new_tokens=40, eos_ids=(tok.eos_token_id,),
                         pad_id=tok.pad_token_id)
    want, hist = "spider-tpu chat (empty line to exit)\n", ""
    for user in ("Hello", "And then?"):
        hist += f"User: {user}\nAssistant:"
        ids = tok(hist, add_special_tokens=True).input_ids
        with torch.inference_mode():
            emb = model.embed(torch.tensor([ids]))
        toks = generate(model, emb, torch.tensor([len(ids)], dtype=torch.int32),
                        cfg)["tokens"][0].tolist()
        if tok.eos_token_id in toks:
            toks = toks[: toks.index(tok.eos_token_id) + 1]
        want += "bot> " + "".join(tok.decode([t], skip_special_tokens=True) for t in toks) + "\n"
        hist += tok.decode(toks, skip_special_tokens=True) + "\n"
    assert printed == want and history == hist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main([])


def test_gradio_twin_serves_a_chat(ckpt_dir, monkeypatch):
    from spider_tpu_torch import r1_llama3_8B_gradio as twin
    from spider_tpu_torch.models.serving_utils import load_or_init_llm
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    monkeypatch.setenv("SPIDER_TPU_LLM_CKPT", ckpt_dir)
    server = twin.main(["--port", "0", "--device", "cpu", "--max-new-tokens", "24"],
                       background=True)
    try:
        port = server.server_address[1]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/chat",
                                     data=json.dumps({"text": "Hello"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    # no decoders and no tag system prompt: the answer is the chat turn; the
    # speculative decode gives the greedy stream
    model, tok = load_or_init_llm(ckpt_dir, device="cpu")
    greedy = make_llama_chat_fn(model, tok, max_new_tokens=24)("\nUser: Hello\nOutput:")
    assert out == {"answer": greedy.strip(), "events": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main(["--port", "0"], background=True)
