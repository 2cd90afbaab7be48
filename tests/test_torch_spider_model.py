"""Parity of the port's trainable Spider with the JAX package: host-side
batch preparation, the loss dicts, and the gradient of every trainable leaf.

Both models are the tiny Spider (llama_tiny with LoRA r 4, imagebind_tiny,
tiny aligners). The JAX model's own random weights (with the LoRA b
matrices, which start at zero, made non-zero) reach the port as numpy through
``convert.load_jax_spider``; samples and conditioning targets are made with
numpy from a seed. fp32 on the CPU. Losses are held to 1e-4 relative (they
are sums over up to 77 x 32 squared errors of O(1) values); gradients to
2e-4 + 1e-3 |jax|: the same fp32 arithmetic in another summation order,
through two decoder layers and a 4+4-layer aligner.
"""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import factory as jF
from spider_tpu.models import spider as jS
from spider_tpu_torch.models import factory as tF
from spider_tpu_torch.models import spider as tS
from spider_tpu_torch.models.convert import load_jax_spider, spider_trainable_to_jax


class StubPipe:
    """A frozen decoder's text encoder: a fixed table looked up by caption
    length, the same numbers for both packages."""

    def __init__(self, shape, seed):
        self.table = np.random.default_rng(seed).standard_normal((32,) + shape).astype(
            np.float32)

    def __call__(self, prompt, return_prompts_only=True):
        assert return_prompts_only
        return np.stack([self.table[len(p) % 32] for p in prompt])


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _pair(use_moe=False, pipes=None, **kw):
    """(JAX Spider, port Spider) on the same weights."""
    js = jF.build_tiny_spider(use_moe_aligner=use_moe, with_pipes=False, **kw)
    rng = np.random.default_rng(0)
    tree = _numpy_tree(js.trainable_params())

    def lora_b(path, x):
        if "lora_b" in jax.tree_util.keystr(path):
            return 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    tree = jax.tree_util.tree_map_with_path(lora_b, tree)
    js.update_params(jax.tree_util.tree_map(jnp.asarray, tree))
    ts = tF.build_tiny_spider(device="cpu", use_moe_aligner=use_moe, with_pipes=False, **kw)
    load_jax_spider(ts, tree, _numpy_tree(js.encoder_params))
    if pipes:
        js.diffusion_pipes = dict(pipes)
        ts.diffusion_pipes = dict(pipes)
    return js, ts


def _samples(task, B=2, seed=0):
    rng = np.random.default_rng(seed)
    img = lambda: rng.standard_normal((3, 2, 28, 28)).astype(np.float32)
    aud = lambda: rng.standard_normal((3, 1, 16, 20)).astype(np.float32)
    caps = ["a dog runs", "two red birds on a wire"][:B]
    if task in ("IMAGE", "VIDEO", "AUDIO"):
        return {"Question": [f"please make: {c}" for c in caps],
                "TaskPrompt": [f"[{task}]"] * B,
                "Answer": [f"<{task}>{c}<{task}-Placeholder></{task}>" for c in caps],
                "Caption": caps}
    if task == "TEXT":     # image and audio in, text out
        return {"Question": ["look at <IMAGE><IMAGE-Placeholder></IMAGE> and hear "
                             "<AUDIO><AUDIO-Placeholder></AUDIO>",
                             "what is <IMAGE><IMAGE-Placeholder></IMAGE>"][:B],
                "TaskPrompt": ["[TEXT]"] * B, "Answer": caps,
                "IMAGE": [img() for _ in range(B)], "AUDIO": [aud(), None][:B]}
    if task == "MASK":
        return {"Question": ["segment the dog in <IMAGE><IMAGE-Placeholder></IMAGE>"] * B,
                "TaskPrompt": ["[MASK]"] * B,
                "Answer": ["<MASK>dog<MASK-Placeholder></MASK>"] * B,
                "IMAGE": [img() for _ in range(B)]}
    raise ValueError(task)


def _assert_batches_equal(a, b):
    for field in ("input_ids", "targets", "signal_pos", "text_span"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=field)
    for field in ("slot_mask", "slot_index", "modality_inputs"):
        x, y = getattr(a, field), getattr(b, field)
        assert set(x) == set(y), field
        for m in x:
            np.testing.assert_array_equal(x[m], y[m], err_msg=f"{field}[{m}]")


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("task", ["IMAGE", "VIDEO", "AUDIO", "TEXT", "MASK"])
def test_prepare_batch_equal_field_by_field(pair, task):
    js, ts = pair
    samples = _samples(task)
    _assert_batches_equal(ts.prepare_batch(samples), js.prepare_batch(samples))


def test_prepare_batch_truncates_like_the_reference():
    js, ts = _pair(max_context_len=12)
    samples = _samples("TEXT")
    a, b = ts.prepare_batch(samples), js.prepare_batch(samples)
    _assert_batches_equal(a, b)
    assert a.input_ids.shape[1] <= 24


def test_host_helpers_equal():
    s = "<IMAGE><IMAGE-Placeholder></IMAGE> a dog <AUDIO-Placeholder>"
    assert tS.split_placeholder(s) == jS.split_placeholder(s)
    assert tS.get_modality("<VIDEO-Placeholder>") == jS.get_modality("<VIDEO-Placeholder>")
    t = "[OUTPUT]<MASK>apple[MASK0]</MASK>[END]"
    assert (tS.get_llm_text_res_train(t, "MASK") == jS.get_llm_text_res_train(t, "MASK")
            == ["apple"])


def test_loss_functions_match_jax():
    rng = np.random.default_rng(2)
    u, v = (rng.standard_normal((3, 5, 8)).astype(np.float32) for _ in range(2))
    pred = (3 * rng.standard_normal((2, 6, 6))).astype(np.float32)
    gt = (rng.random((2, 6, 6)) > 0.5).astype(np.float32)
    pairs = [
        (tS.l2_loss(torch.from_numpy(u), torch.from_numpy(v)),
         jS.l2_loss(jnp.asarray(u), jnp.asarray(v))),
        (tS.clip_align_loss(torch.from_numpy(u), torch.from_numpy(v), torch.tensor(0.7)),
         jS.clip_align_loss(jnp.asarray(u), jnp.asarray(v), jnp.asarray(0.7))),
        (tS.sigmoid_bce_loss(torch.from_numpy(pred), torch.from_numpy(gt)),
         jS.sigmoid_bce_loss(jnp.asarray(pred), jnp.asarray(gt))),
        (tS.dice_loss(torch.from_numpy(pred), torch.from_numpy(gt)),
         jS.dice_loss(jnp.asarray(pred), jnp.asarray(gt))),
    ]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)


def _cond(task, B, seed=1):
    shape = {"IMAGE": (B, 77, 32), "VIDEO": (B, 77, 32), "AUDIO": (B, 16)}[task]
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _loss_dicts(js, ts, task, cond):
    samples = _samples(task)
    jb, tb = js.prepare_batch(samples), ts.prepare_batch(samples)
    jout = js.compute_loss(js.trainable_params(), jb, js.encode_modalities(jb),
                           None if cond is None else jnp.asarray(cond), task)
    tout = ts.compute_loss(tb, ts.encode_modalities(tb),
                           None if cond is None else torch.from_numpy(cond), task)
    return jout, tout


def _assert_dicts_close(tout, jout):
    assert set(tout) == set(jout)
    for k in jout:
        assert float(tout[k].detach()) == pytest.approx(float(jout[k]), rel=1e-4, abs=1e-4), k


@pytest.mark.parametrize("task", ["IMAGE", "VIDEO", "AUDIO"])
def test_compute_loss_matches_jax(pair, task):
    jout, tout = _loss_dicts(*pair, task, _cond(task, 2))
    assert f"{task}_semantic_align_mse_loss" in tout
    _assert_dicts_close(tout, jout)


@pytest.mark.parametrize("task", ["TEXT", "MASK"])
def test_forward_matches_jax_for_text_and_for_mask_without_sam(pair, task):
    js, ts = pair
    samples = _samples(task)
    jout, tout = js.forward(samples), ts(samples)
    assert set(tout) == {"loss", "gen_loss", "gen_acc"}
    _assert_dicts_close(tout, jout)


def _grads_as_jax_tree(ts, loss):
    """Backpropagate and read the gradients out in the JAX tree's layout."""
    ts.zero_grad()
    loss.backward()
    shadow = copy.deepcopy(ts)
    with torch.no_grad():
        for (n, p), (_, q) in zip(ts.named_parameters(), shadow.named_parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return spider_trainable_to_jax(shadow)


def _assert_trees_close(got, want, atol, rtol):
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    want_flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(map(jax.tree_util.keystr, got_flat)) == set(map(jax.tree_util.keystr, want_flat))
    live = 0
    for path, w in want_flat.items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got_flat[path]), w, atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))
        live += bool(np.abs(w).max() > 0)
    return live


@pytest.mark.parametrize("use_moe,task", [(False, "IMAGE"), (True, "AUDIO")])
def test_gradients_of_every_trainable_leaf_match_jax_grad(use_moe, task):
    js, ts = _pair(use_moe=use_moe)
    samples = _samples(task)
    samples["Question"] = [q + " <IMAGE><IMAGE-Placeholder></IMAGE>" for q in
                           samples["Question"]]            # llama_proj gets a gradient too
    samples["IMAGE"] = _samples("TEXT")["IMAGE"]
    cond = _cond(task, 2)
    jb, tb = js.prepare_batch(samples), ts.prepare_batch(samples)
    jemb = js.encode_modalities(jb)

    def loss_fn(tree):
        return js.compute_loss(tree, jb, jemb, jnp.asarray(cond), task)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(js.trainable_params())
    tout = ts.compute_loss(tb, ts.encode_modalities(tb), torch.from_numpy(cond), task)
    assert float(tout["loss"].detach()) == pytest.approx(float(jloss), rel=1e-4)
    live = _assert_trees_close(_grads_as_jax_tree(ts, tout["loss"]), _numpy_tree(jgrads),
                               atol=2e-4, rtol=1e-3)
    assert live > 20      # LoRA pairs, embeddings, projection, aligner, logit_scale
    if use_moe:           # modalities the batch did not use get zero gradient
        assert ts.moe_aligner.out_fc_IMAGE.weight.grad is None
    assert all(p.grad is None for p in ts.encoder.parameters())


def test_embed_and_word_align_losses_match_jax():
    pipes = {"IMAGE": StubPipe((77, 32), seed=3)}
    js, ts = _pair(pipes=pipes, use_embed_align_loss=True, word_align_loss=True,
                   modality_tokens={"IMAGE": 77, "VIDEO": 8, "AUDIO": 4, "MASK": 1,
                                    "BOX": 1})
    samples = _samples("IMAGE")
    # captions of one token length: the aligner maps [B, L, H] -> [B, 77, 32]
    random.seed(5)
    jout = js.forward(samples)
    random.seed(5)
    tout = ts(samples)
    assert "IMAGE_embed_align_mse_loss" in tout and "IMAGE_semantic_align_mse_loss" in tout
    _assert_dicts_close(tout, jout)
    # only_embed_align_loss returns the alignment loss alone
    js.only_embed_align_loss = ts.only_embed_align_loss = True
    random.seed(6)
    jout = js.forward(samples)
    random.seed(6)
    tout = ts(samples)
    _assert_dicts_close(tout, jout)


def test_trainable_tree_round_trips_through_the_converters(pair):
    js, ts = pair
    want = _numpy_tree(js.trainable_params())
    _assert_trees_close(spider_trainable_to_jax(ts), want, atol=0, rtol=0)
    assert set(ts.trainable_params()) == {n for n, _ in ts.named_parameters()
                                          if not n.startswith("encoder.")}


def test_sam_is_refused_until_it_is_ported():
    # SAM is ported (tests/test_torch_mask.py holds its MASK branch): the
    # tiny Spider takes it, with its encoders frozen and the MASK aligner in
    # its prompt space
    ts = tF.build_tiny_spider(device="cpu", with_sam=True, with_pipes=False)
    assert ts.aligners["MASK"].model.weight.shape[0] == ts.sam.config.prompt_embed_dim
    assert not any(p.requires_grad for p in ts.sam.image_encoder.parameters())
    assert any(n.startswith("sam.mask_decoder.") for n in ts.trainable_params())
