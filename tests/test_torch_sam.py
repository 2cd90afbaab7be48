"""Parity of the port's Segment Anything with the JAX package: the ViT block
(global and windowed), the image encoder, the prompt encoder, the two-way
mask decoder, ``Sam.predict_box`` / ``predict_text``, ``postprocess_masks``
and the SAM rule set.

Weights: the flax init of ``sam_tiny`` (fixed keys) with N(0, 0.05) noise
added to every leaf (the relative positions start at zero), carried to the
port through ``load_jax_params``; inputs are made with numpy from a seed.
fp32 on the CPU. Module outputs are held to 1e-4 absolute (the same fp32
arithmetic in another summation order); resized masks, whose values reach
~3, to 1e-4 as well; converted tensors are equal exactly.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import convert as JC
from spider_tpu.models import sam as jSam
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import sam as tSam
from spider_tpu_torch.models.convert import load_jax_params
from test_torch_grounding import _assert_same_state, _manifest, _np_tree, _x, perturbed

ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _sam():
    cfg = jSam.sam_tiny()
    m = jSam.Sam(cfg)
    params = perturbed(m.init(jax.random.PRNGKey(4), jnp.zeros((1, 3, 64, 64)),
                              boxes=jnp.zeros((1, 1, 4))), 4)
    return m, params, load_jax_params(tSam.Sam(tSam.sam_tiny()), params).eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,hw", [(0, 6), (2, 6), (4, 6)],
                         ids=["global", "window", "window_padded"])
def test_vit_block_matches_jax(window, hw):
    jm = jSam.SamViTBlock(heads=2, window_size=window, dtype=jnp.float32)
    x = _x((2, hw, hw, 16), seed=window)
    params = perturbed(jm.init(jax.random.PRNGKey(5), jnp.asarray(x)), 5)
    tm = load_jax_params(tSam.SamViTBlock(16, 2, window, window or hw, torch.float32), params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_image_encoder_matches_jax():
    m, params, tm = _sam()
    x = _x((2, 3, 64, 64), seed=12)
    want = m.apply(params, jnp.asarray(x), method=m.encode_image)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 16)
    _close(got, want)


def _prompts(seed):
    rng = np.random.default_rng(seed)
    boxes = np.sort(rng.uniform(0, 64, (2, 1, 2, 2)), axis=2).reshape(2, 1, 4).astype(np.float32)
    pts = rng.uniform(0, 64, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [0, 1, 1]], np.int32)
    text = rng.standard_normal((2, 2, 16)).astype(np.float32)
    return boxes, (pts, labels), text


@pytest.mark.parametrize("kinds", [("boxes",), ("points",), ("text",),
                                   ("points", "boxes", "text")])
def test_prompt_encoder_matches_jax(kinds):
    m, params, tm = _sam()
    boxes, points, text = _prompts(13)
    given = {"boxes": boxes, "points": points, "text_embeds": text}
    given = {k: v for k, v in given.items() if k.split("_")[0] in kinds}
    jkw = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in given.items()}
    tkw = {k: jax.tree_util.tree_map(torch.from_numpy, v) for k, v in given.items()}

    def run(mod, **a):
        return mod.prompt_encoder(**a), mod.prompt_encoder.get_dense_pe()

    (want_sparse, want_dense), want_pe = m.apply(params, **jkw, method=run)
    with torch.no_grad():
        (sparse, dense), pe = run(tm, **tkw)
    _close(sparse, want_sparse)
    _close(dense, want_dense)
    _close(pe, want_pe)


def test_prompt_encoder_needs_a_prompt():
    _, _, tm = _sam()
    with pytest.raises(ValueError, match="at least one prompt"):
        tm.prompt_encoder()


@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(multimask):
    m, params, tm = _sam()
    emb = _x((2, 4, 4, 16), seed=14)
    boxes, points, _ = _prompts(15)

    def run(mod, emb, boxes, points):
        return mod.decode(emb, boxes=boxes, points=points, multimask_output=multimask)

    want = m.apply(params, jnp.asarray(emb), jnp.asarray(boxes),
                   tuple(map(jnp.asarray, points)), method=run)
    with torch.no_grad():
        got = run(tm, torch.from_numpy(emb), torch.from_numpy(boxes),
                  tuple(map(torch.from_numpy, points)))
    n = 3 if multimask else 1
    assert got[0].shape == (2, n, 16, 16) and got[1].shape == (2, n)
    for g, w in zip(got, want):
        _close(g, w)


def test_predict_box_and_predict_text_match_jax_and_keep_the_encoder_out_of_the_graph():
    m, params, tm = _sam()
    img = _x((2, 3, 64, 64), seed=16)
    boxes, _, text = _prompts(17)
    want_box = m.apply(params, jnp.asarray(img), jnp.asarray(boxes), method=m.predict_box)
    want_text = m.apply(params, jnp.asarray(img), jnp.asarray(text), method=m.predict_text)
    got_box = tm.predict_box(torch.from_numpy(img), torch.from_numpy(boxes))
    got_text = tm(torch.from_numpy(img), text_embeds=torch.from_numpy(text))
    _close(got_box, want_box)
    _close(got_text, want_text)
    got_text.sum().backward()
    assert all(p.grad is None for p in tm.image_encoder.parameters())
    assert tm.mask_decoder.upscale_1.weight.grad is not None


@pytest.mark.parametrize("case", ["upsample", "downsample", "train_identity"])
def test_postprocess_masks_matches_jax(case):
    # downsample: a 1024 px frame to a smaller, non-square original (the
    # reference's jax.image.resize antialiases there); train_identity: the
    # MASK loss's call, ground truth at the SAM size
    masks = (3 * _x((2, 1, 64, 64), seed=18))
    args = {"upsample": ((200, 256), (300, 384), 256),
            "downsample": ((1024, 768), (600, 450), 1024),
            "train_identity": ((256, 256), (256, 256), 256)}[case]
    want = jSam.postprocess_masks(jnp.asarray(masks), *args[:2], img_size=args[2])
    got = tSam.postprocess_masks(torch.from_numpy(masks), *args[:2], img_size=args[2])
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_conv_transpose_maps_flax_kernels_unflipped():
    # flax's nn.ConvTranspose applies its kernel unflipped; load_jax_params
    # flips it for torch's ConvTranspose2d, which flips its weight
    jm = fnn.ConvTranspose(6, (2, 2), strides=(2, 2))
    x = _x((2, 3, 5, 8), seed=19)
    params = perturbed(jm.init(jax.random.PRNGKey(6), jnp.asarray(x)), 6)
    tm = load_jax_params(tSam.ConvTranspose2x2(8, 6, torch.float32), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm.apply(params, jnp.asarray(x)))
    # the same weight unflipped (upstream SAM's reading of a checkpoint) differs
    with torch.no_grad():
        tm.weight.copy_(tm.weight.flip(2, 3))
        assert (tm(torch.from_numpy(x)) - got).abs().max() > 1e-2


def test_sam_parts_compute_in_their_dtype_with_fp32_parameters():
    # the training operating point: a bf16 encoder's embeddings into a mask
    # decoder whose parameters are fp32 and whose compute is bf16
    cfg = dataclasses.replace(tSam.sam_tiny(), dtype=torch.bfloat16)
    sam = factory.random_init_(tSam.Sam(cfg), torch.Generator().manual_seed(0))
    sam.mask_decoder.float()
    img = torch.from_numpy(_x((1, 3, 64, 64), seed=20))
    text = torch.randn(1, 1, 16, generator=torch.Generator().manual_seed(1))
    masks = sam.predict_text(img, text)
    assert masks.dtype == torch.bfloat16 and torch.isfinite(masks.float()).all()
    masks.float().sum().backward()
    assert sam.mask_decoder.final_q.weight.grad.dtype == torch.float32


# ---- the rule set ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sam_ckpt():
    from test_convert_diffusion import make_sam_sd

    cfg = jSam.sam_tiny()
    sd = make_sam_sd(cfg)[0]
    return sd, JC.convert_sam_state_dict(sd, cfg), TC.convert_sam_state_dict(sd, tSam.sam_tiny())


def test_sam_rules_match_the_reference_converter_bit_for_bit():
    sd, ref_tree, port_state = _sam_ckpt()
    got = tSam.Sam(tSam.sam_tiny())
    got.load_state_dict(port_state, strict=True)
    _assert_same_state(got, load_jax_params(tSam.Sam(tSam.sam_tiny()), _np_tree(ref_tree)))
    back = TC.export_state_dict(TC.sam_rules(sd, tSam.sam_tiny()), port_state)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)


def test_sam_rules_compose_to_the_reference_converter_and_module():
    # a checkpoint through the reference converter and the JAX module, and
    # through sam_rules and the port module: the same masks (the upscaling
    # weights flipped by tflip, then unflipped by ConvTranspose2d)
    sd, ref_tree, port_state = _sam_ckpt()
    rng = np.random.default_rng(21)
    sd = {k: (np.asarray(v) + 0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in sd.items()}
    m = jSam.Sam(jSam.sam_tiny())
    tm = tSam.Sam(tSam.sam_tiny())
    tm.load_state_dict(TC.convert_sam_state_dict(sd, tSam.sam_tiny()), strict=True)
    img = _x((1, 3, 64, 64), seed=22)
    boxes = np.array([[[4.0, 9.0, 40.0, 50.0]]], np.float32)
    want = m.apply(JC.convert_sam_state_dict(sd, jSam.sam_tiny()), jnp.asarray(img),
                   jnp.asarray(boxes), method=m.predict_box)
    with torch.no_grad():
        _close(tm.predict_box(torch.from_numpy(img), torch.from_numpy(boxes)), want)


def test_full_preset_reads_exactly_the_manifest():
    keys = set(_manifest("sam_vit_h"))
    cfg = tSam.sam_vit_h()
    module = tSam.Sam(cfg, "meta")
    rules = TC.sam_rules(keys, cfg)
    read = [k for r in rules for k in r.keys]
    filled = [n for r in rules for n in r.names]
    assert len(read) == len(set(read)) and len(filled) == len(set(filled))
    assert set(read) == keys and set(filled) == set(module.state_dict())
    state = module.state_dict()
    assert tuple(state["image_encoder.block_7.rel_pos_h"].shape) == (127, 80)   # global
    assert tuple(state["image_encoder.block_0.rel_pos_h"].shape) == (27, 80)    # window 14
    assert tuple(state["mask_decoder.upscale_1.weight"].shape) == (256, 64, 2, 2)


def test_sam_from_checkpoint_file(tmp_path, monkeypatch):
    sd, ref_tree, _ = _sam_ckpt()
    path = str(tmp_path / "sam_vit_h.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    monkeypatch.setattr(tSam, "sam_vit_h", tSam.sam_tiny)
    got = factory.from_pretrained("sam", path=path, device="cpu", dtype=torch.float32)
    _assert_same_state(got, load_jax_params(tSam.Sam(tSam.sam_tiny()), _np_tree(ref_tree)))
    rand = factory.from_pretrained("sam", device="cpu", dtype=torch.bfloat16, seed=3)
    assert rand.image_encoder.block_0.q.weight.dtype == torch.bfloat16
    assert not rand.training
