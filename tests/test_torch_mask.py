"""The MASK branch of the port against the JAX package: Spider's MASK loss
(2 BCE + 0.5 dice of SAM's masks from the projected [MASK0] state) and its
gradients, the frozen SAM parts left out of the optimizer, the runner's MASK
batch, ``_decode_mask_infer``, and the BOX and MASK decoders of the
``spider_decoder_infer`` twin behind SpiderDecoderInfer and SpiderFree.

Both Spiders are the tiny one with ``sam_tiny`` (64 px, prompt width 16):
the JAX model's random weights (LoRA b made non-zero) reach the port
through ``load_jax_spider``; samples are made with numpy from a seed. fp32
on the CPU. Losses are held to 1e-4 relative, gradients to 2e-4 + 1e-3 |jax|
(the tolerances of tests/test_torch_spider_model.py), masks to 1e-4
absolute.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import factory as jF
from spider_tpu_torch.models import factory as tF
from spider_tpu_torch.models.convert import load_jax_spider, spider_trainable_to_jax
from spider_tpu_torch.processors.vision import sam_preprocess
from spider_tpu_torch.runners.runner import RunnerBase
from spider_tpu_torch.runners.train_step import backward_and_step, build_optimizer
from test_torch_spider_model import _assert_trees_close, _numpy_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAM_PX = 64


def _pair():
    """(JAX Spider, port Spider) with SAM, on the same weights."""
    js = jF.build_tiny_spider(with_pipes=False, with_sam=True)
    rng = np.random.default_rng(0)
    tree = _numpy_tree(js.trainable_params())

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if "lora_b" in key or "sam" in key:
            return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    js.update_params(jax.tree_util.tree_map(jnp.asarray, tree))
    ts = tF.build_tiny_spider(device="cpu", with_pipes=False, with_sam=True)
    load_jax_spider(ts, tree, _numpy_tree(js.encoder_params))
    return js, ts


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _mask_samples(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"Question": ["segment the dog in <IMAGE><IMAGE-Placeholder></IMAGE>"] * B,
            "TaskPrompt": ["[MASK]"] * B,
            "Answer": ["<MASK>dog<MASK-Placeholder></MASK>"] * B,
            "IMAGE": [rng.standard_normal((3, 2, 28, 28)).astype(np.float32)
                      for _ in range(B)],
            "IMAGE_SAM": [rng.standard_normal((3, SAM_PX, SAM_PX)).astype(np.float32)
                          for _ in range(B)],
            "MASK": [(rng.random((SAM_PX, SAM_PX)) > 0.6).astype(np.float32)
                     for _ in range(B)]}


def _close_dicts(tout, jout):
    assert set(tout) == set(jout)
    for k in jout:
        assert float(tout[k].detach()) == pytest.approx(float(jout[k]), rel=1e-4, abs=1e-4), k


def test_mask_forward_matches_jax(pair):
    js, ts = pair
    samples = _mask_samples()
    jout, tout = js.forward(samples), ts(samples)
    assert {"bce_loss", "dice_loss"} <= set(tout)
    _close_dicts(tout, jout)
    parts = tout["gen_loss"] + tout["bce_loss"] + tout["dice_loss"]
    assert float(tout["loss"].detach()) == pytest.approx(float(parts.detach()), rel=1e-6)


def test_mask_without_image_sam_trains_the_text_loss(pair):
    js, ts = pair
    samples = _mask_samples()
    del samples["IMAGE_SAM"]
    jout, tout = js.forward(samples), ts(samples)
    assert set(tout) == {"loss", "gen_loss", "gen_acc"}
    _close_dicts(tout, jout)


def _grads_as_jax_tree(ts, loss):
    ts.zero_grad()
    loss.backward()
    shadow = copy.deepcopy(ts)
    with torch.no_grad():
        for (n, p), (_, q) in zip(ts.named_parameters(), shadow.named_parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return spider_trainable_to_jax(shadow)


def test_mask_gradients_match_jax_grad_and_the_frozen_sam_parts_get_none(pair):
    js, ts = pair
    samples = _mask_samples(seed=1)
    jb, tb = js.prepare_batch(samples), ts.prepare_batch(samples)
    aux = ts.mask_arrays(samples)
    jemb = js.encode_modalities(jb)

    def loss_fn(tree):
        return js.compute_loss(tree, jb, jemb, None, "MASK", aux)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(js.trainable_params())
    tout = ts.compute_loss(tb, ts.encode_modalities(tb), None, "MASK", aux)
    assert float(tout["loss"].detach()) == pytest.approx(float(jloss), rel=1e-4)
    want = _numpy_tree(jgrads)
    # the reference stops the gradient into SAM's image and prompt encoders
    frozen = {k: want["sam"]["params"].pop(k) for k in ("image_encoder", "prompt_encoder")}
    assert all(not np.abs(x).max() for x in jax.tree_util.tree_leaves(frozen))
    got = _grads_as_jax_tree(ts, tout["loss"])
    live = _assert_trees_close(got, want, atol=2e-4, rtol=1e-3)
    assert live > 40          # the mask decoder, the MASK aligner, LoRA, embeddings
    assert np.abs(got["sam"]["params"]["mask_decoder"]["upscale_1"]["kernel"]).max() > 0
    assert all(p.grad is None for p in ts.sam.image_encoder.parameters())
    assert all(p.grad is None for p in ts.sam.prompt_encoder.parameters())


def test_frozen_sam_parts_stay_out_of_the_optimizer_and_keep_their_bits():
    _, ts = _pair()
    names = set(ts.trainable_params())
    assert any(n.startswith("sam.mask_decoder.") for n in names)
    assert not any(n.startswith(("sam.image_encoder.", "sam.prompt_encoder.")) for n in names)
    frozen = {k: v.clone() for k, v in ts.sam.state_dict().items()
              if not k.startswith("mask_decoder.")}
    decoder = {k: v.clone() for k, v in ts.sam.mask_decoder.state_dict().items()}
    opt = build_optimizer(1e-3, params=ts.trainable_params(), weight_decay=0.05)
    backward_and_step(ts(_mask_samples(seed=2))["loss"], opt)
    state = ts.sam.state_dict()
    assert all(torch.equal(state[k], v) for k, v in frozen.items())
    moved = ts.sam.mask_decoder.state_dict()
    assert any(not torch.equal(moved[k], v) for k, v in decoder.items())


def test_runner_mask_batch_goes_through_sam(pair):
    _, ts = pair
    runner = RunnerBase.__new__(RunnerBase)          # the loss path alone
    runner.model, runner.length_bucket = ts, 32
    samples = _mask_samples(seed=3)
    out = runner.loss_dict(samples)
    want = ts(samples)
    assert {"bce_loss", "dice_loss"} <= set(out)
    for k in ("bce_loss", "dice_loss"):
        assert float(out[k].detach()) == pytest.approx(float(want[k].detach()), rel=1e-5)
    assert float(out["gen_loss"].detach()) == pytest.approx(float(want["gen_loss"].detach()),
                                                            rel=1e-4)


class StubBoxes:
    """A box decoder that finds one fixed box (original pixels)."""

    def __init__(self, boxes):
        self.boxes, self.calls = boxes, []

    def __call__(self, image, caption):
        self.calls.append((image.shape, caption))
        return dict(bboxes=[list(b) for b in self.boxes], label_names=[caption] * len(self.boxes),
                    scores=[0.9] * len(self.boxes))


def _inference_samples(seed=4):
    img = np.random.default_rng(seed).integers(0, 255, (48, 80, 3), np.uint8)
    sam_img, sam_hw = sam_preprocess(img, size=SAM_PX)
    return {"Question": ["segment the dog"], "Image_ori_array": [img], "IMAGE_SAM": [sam_img],
            "Meta_info": {"original_shape": [img.shape[:2]], "sam_shape": [sam_hw]}}


def test_decode_mask_infer_matches_jax(pair):
    js, ts = pair
    samples = _inference_samples()
    js.box_decoder = ts.box_decoder = StubBoxes([[8.0, 4.0, 60.0, 40.0], [1.0, 1.0, 5.0, 5.0]])
    try:
        want = js._decode_mask_infer(0, "dog", None, None, samples)
        got = ts._decode_mask_infer(0, "dog", None, None, samples)
        assert got.shape == want.shape == (1, 16, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
        # through the modality dispatch, and nothing without a detection or an image
        again = ts._decode_modality_infer("MASK", 0, "dog", None, None, samples, 7.5, 1)
        np.testing.assert_array_equal(again, got)
        ts.box_decoder = StubBoxes([])
        assert ts._decode_mask_infer(0, "dog", None, None, samples) is None
        assert ts._decode_mask_infer(0, "dog", None, None, {"Question": ["x"]}) is None
    finally:
        js.box_decoder = ts.box_decoder = None


# ---- the spider_decoder_infer twin ---------------------------------------------

@pytest.fixture(scope="module")
def grounding():
    from spider_tpu_torch.spider_decoder_infer import build_grounding

    return build_grounding(tiny=True, device="cpu")


def test_twin_mask_decoder_is_box_prompted_sam(grounding):
    from spider_tpu_torch.spider_decoder_infer import mask_decoder

    _, sam = grounding
    samples = _inference_samples(seed=5)
    box = np.array([3.0, 5.0, 50.0, 30.0], np.float32)
    chw = samples["IMAGE_SAM"][0]
    got = mask_decoder(sam)(chw, box)
    with torch.no_grad():
        want = sam.predict_box(torch.from_numpy(chw)[None], torch.from_numpy(box).reshape(1, 1, 4))
    np.testing.assert_array_equal(got, want[0].numpy())
    np.testing.assert_array_equal(mask_decoder(sam)(chw.transpose(1, 2, 0), box), got)  # HWC


def test_box_and_mask_behind_spider_decoder_infer_and_spider_free(grounding):
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer
    from spider_tpu_torch.serving.spider_free import SpiderFree
    from spider_tpu_torch.spider_decoder_infer import mask_decoder

    dino, sam = grounding
    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    decoders = {"BOX": dino, "MASK": mask_decoder(sam)}
    samples = _inference_samples(seed=6)
    det = dino(samples["Image_ori_array"][0], "apple")
    assert det["scores"][0] >= 0.3          # random weights: scores near one half
    infer = SpiderDecoderInfer(cfg, decoders=decoders)
    answers, preds, texts = infer(dict(samples, llm_text_all=["<BOX>apple</BOX> and "
                                                              "<MASK>apple</MASK>"]))
    assert texts["BOX"] == ["apple"] and texts["MASK"] == ["apple"]
    kept = [s for s in det["scores"] if s >= 0.3]
    assert preds["BOX"]["scores"][0] == kept[: len(preds["BOX"]["scores"][0])]
    (mask,) = preds["MASK"]
    oh, ow = samples["Meta_info"]["original_shape"][0]
    sh, sw = samples["Meta_info"]["sam_shape"][0]
    box = np.asarray(det["bboxes"][0], np.float32) * np.array([sw / ow, sh / oh] * 2, np.float32)
    np.testing.assert_array_equal(mask, mask_decoder(sam)(samples["IMAGE_SAM"][0], box))
    # the same spans through SpiderFree's chat
    sf = SpiderFree(cfg, chat_fn=lambda p: "Here: <BOX>apple</BOX><MASK>apple</MASK>",
                    decoders=decoders)
    events, _, preds2, _ = sf.chat("find the apple", extra_inputs=samples)
    assert [kind for kind, _ in events] == ["text", "mask", "box"]     # the controller's order
    np.testing.assert_array_equal(preds2["MASK"][0], mask)


def test_spider_decoder_infer_twin_runs_on_the_cpu():
    from spider_tpu_torch.spider_decoder_infer import build_default_decoders, main

    answers, preds, texts = main(["--device", "cpu"])
    assert answers == ["<IMAGE>apple</IMAGE><VIDEO>dog</VIDEO><AUDIO>cat</AUDIO>"]
    assert [len(preds[m]) for m in ("IMAGE", "VIDEO", "AUDIO")] == [1, 1, 1]
    assert texts["IMAGE"] == ["apple"] and texts["AUDIO"] == ["cat"]
    decoders = build_default_decoders(tiny=True, device="cpu")
    assert set(decoders) == {"IMAGE", "VIDEO", "AUDIO", "BOX", "MASK"}
    assert set(build_default_decoders(tiny=True, with_grounding=False, device="cpu")) == {
        "IMAGE", "VIDEO", "AUDIO"}


def test_full_spider_with_sam_freezes_and_loads(tmp_path, monkeypatch):
    from spider_tpu_torch.models import imagebind as tib
    from spider_tpu_torch.models import llama as tL
    from spider_tpu_torch.models import sam as tSam

    monkeypatch.setattr(tSam, "sam_vit_h", tSam.sam_tiny)
    monkeypatch.setattr(tL, "llama3_8b", lambda: tL.llama_tiny(vocab_size=300))
    monkeypatch.setattr(tib, "imagebind_huge", tib.imagebind_tiny)
    monkeypatch.setattr(tF, "_llama_proj",
                        lambda e, h, d, g: torch.nn.Linear(tib.imagebind_tiny().embed_dim, h))
    monkeypatch.setattr(tF, "FULL_ALIGN_SPECS", {"MASK": dict(
        alignment_input_tokens=1, alignment_output_tokens=1, alignment_output_dim=16)})
    spider = tF.build_full_spider(device="cpu", dtype=torch.bfloat16, lora_r=2,
                                  use_moe_aligner=False, with_sam=True)
    assert spider.sam.image_encoder.block_0.q.weight.dtype == torch.bfloat16
    assert spider.sam.mask_decoder.final_q.weight.dtype == torch.float32
    assert not any(p.requires_grad for p in spider.sam.image_encoder.parameters())
    assert not any(p.requires_grad for p in spider.sam.prompt_encoder.parameters())
    with pytest.raises(ValueError, match="with_sam"):
        tF.build_full_spider(device="cpu", paths={"sam": "/x"})
