"""Parity of the port's grounding stack with the JAX package: NMS, the
multi-scale deformable attention, BERT, Swin, Grounding DINO and its
``inference_detector`` wrapper, and the four HF/mmdet rule sets' BERT,
Swin and Grounding DINO parts.

Weights: the flax init (fixed keys) with N(0, 0.05) noise added to every
leaf, so that the zero-initialised ones (the deformable offsets and weights)
are live, carried to the port through ``load_jax_params``; inputs are made
with numpy from a seed. fp32 on the CPU at the test widths (``bert_test``,
``swin_test``, ``grounding_dino_test``). Module outputs are held to 1e-4
absolute (the same fp32 arithmetic in another summation order); NMS indices
and converted tensors are equal exactly.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import bert as jB
from spider_tpu.models import convert as JC
from spider_tpu.models import dino as jD
from spider_tpu.models import swin as jS
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu.ops import msda as jmsda
from spider_tpu.ops import nms as jnms
from spider_tpu_torch.models import bert as tB
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import dino as tD
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import swin as tS
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from spider_tpu_torch.ops import msda as tmsda
from spider_tpu_torch.ops import nms as tnms

ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "convert_keys")


def perturbed(params, seed: int, scale: float = 0.05):
    """The flax tree as numpy, every leaf plus N(0, scale) noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        params)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- NMS -------------------------------------------------------------------

def _boxes(n=40, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 50, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[[5, 7, 9, 20]] = scores[3]                  # ties keep the input order
    return boxes, scores, rng.integers(0, 3, n)


def test_box_iou_matches_jax():
    boxes, _, _ = _boxes()
    a, b = boxes[:7], boxes[5:]
    np.testing.assert_allclose(tnms.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jnms.box_iou(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("threshold,max_outputs", [(0.5, 60), (0.3, 10), (0.1, 40)])
def test_nms_indices_equal_jax(threshold, max_outputs):
    boxes, scores, _ = _boxes()
    want = np.asarray(jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), threshold, max_outputs))
    got = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), threshold,
                   max_outputs).numpy()
    np.testing.assert_array_equal(got, want)
    if max_outputs >= 40:
        assert (got == -1).any() and (got[got >= 0] >= 0).all()   # padded with -1


def test_batched_nms_indices_equal_jax():
    boxes, scores, cls = _boxes(seed=1)
    want = np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(cls), 0.3, 30))
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(cls), 0.3, 30).numpy()
    np.testing.assert_array_equal(got, want)


# ---- deformable attention --------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_matches_jax_outside_the_maps_and_on_non_square_levels(dtype):
    shapes = ((5, 7), (3, 4), (2, 2), (1, 3))
    S = sum(h * w for h, w in shapes)
    B, Q, H, D, L, P = 2, 6, 3, 4, 4, 2
    rng = np.random.default_rng(4)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, L, P, 2)).astype(np.float32)
    assert (loc < 0).any() and (loc > 1).any()
    w = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    vt = torch.from_numpy(v).to(dtype)
    want = jmsda.msda(jnp.asarray(vt.float().numpy()), shapes, jnp.asarray(loc), jnp.asarray(w))
    got = tmsda.msda(vt, shapes, torch.from_numpy(loc), torch.from_numpy(w))
    assert got.dtype == dtype and got.shape == (B, Q, H * D)
    tol = ATOL if dtype == torch.float32 else 2 ** -7 * np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=tol, rtol=0)


# ---- BERT and Swin ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bert():
    m = jB.BertModel(jB.bert_test())
    ids = np.random.default_rng(5).integers(0, 300, (3, 9))
    params = perturbed(m.init(jax.random.PRNGKey(1), jnp.asarray(ids)), 1)
    return m, params, load_jax_params(tB.BertModel(tB.bert_test()), params).eval(), ids


@pytest.mark.parametrize("with_mask", [True, False])
def test_bert_matches_jax_with_ragged_kv_len(with_mask):
    m, params, tm, ids = _bert()
    mask = np.ones((3, 9), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    args = (ids, mask) if with_mask else (ids,)
    want = m.apply(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _swin():
    m = jS.SwinTransformer(jS.swin_test())
    params = perturbed(m.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 64, 64))), 2)
    return m, params, load_jax_params(tS.SwinTransformer(tS.swin_test()), params).eval()


@pytest.mark.parametrize("hw", [(64, 64), (44, 52)], ids=["exact", "shifted_padded"])
def test_swin_matches_jax(hw):
    m, params, tm = _swin()
    x = _x((2, 3) + hw, seed=hw[1])
    want = m.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_swin_window_helpers_and_shift_mask_match_jax():
    x = _x((2, 6, 8, 3), seed=6)
    want = np.asarray(jS._window_partition(jnp.asarray(x), 2))
    got = tS._window_partition(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tS._window_reverse(got, 2, 2, 6, 8).numpy(), x)
    # a shifted block's mask: pixels of different regions of the rolled grid
    mask = tS._shift_mask(6, 8, 2, 1)
    assert mask.shape == (12, 4, 4) and set(mask.unique().tolist()) == {-1e9, 0.0}
    assert (mask[:-1] == 0).sum() > 0 and (mask[-1] != 0).any()


def test_swin_refuses_a_map_smaller_than_its_window():
    block = tS.SwinBlock(16, 1, 4, 0, 4.0, torch.float32)
    with pytest.raises(ValueError, match="smaller than the window"):
        block(torch.zeros(1, 3, 8, 16))


# ---- Grounding DINO ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dino():
    cfg = jD.grounding_dino_test()
    m = jD.GroundingDINO(cfg)
    T = cfg.max_text_len
    params = perturbed(m.init(jax.random.PRNGKey(3), jnp.zeros((1, 3, 64, 64)),
                              jnp.ones((1, T), jnp.int32), jnp.ones((1, T), jnp.int32)), 3)
    return m, params, load_jax_params(tD.GroundingDINO(tD.grounding_dino_test()), params).eval()


@pytest.mark.parametrize("with_mask", [True, False])
def test_grounding_dino_outputs_match_jax(with_mask):
    m, params, tm = _dino()
    rng = np.random.default_rng(7)
    img = _x((2, 3, 64, 64), seed=8)
    ids = rng.integers(1, 300, (2, 16))
    mask = np.zeros((2, 16), np.int32)
    mask[0, :7] = 1
    mask[1, :12] = 1
    args = (img, ids, mask) if with_mask else (img, ids)
    want = m.apply(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args))
    assert set(got) == set(want) == {"boxes", "scores", "logits"}
    assert got["boxes"].shape == (2, 20, 4) and got["boxes"].dtype == torch.float32
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_grounding_dino_helpers_match_jax():
    c = np.random.default_rng(9).uniform(0, 1, (3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tD._sine_embed(torch.from_numpy(c), 16).numpy(),
                               np.asarray(jD._sine_embed(jnp.asarray(c), 16)), atol=1e-5)
    np.testing.assert_allclose(tD._inverse_sigmoid(torch.from_numpy(c)).numpy(),
                               np.asarray(jD._inverse_sigmoid(jnp.asarray(c))), atol=1e-5)
    m, params, tm = _dino()
    want = m.apply(params, ((3, 4), (2, 2)), 2, method=m._grid_reference_points)
    got = torch.cat([tD._grid(3, 4, "cpu"), tD._grid(2, 2, "cpu")])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def test_grounding_dino_inference_boxes_match_jax():
    m, params, tm = _dino()
    image = np.random.default_rng(10).integers(0, 255, (96, 128, 3), np.uint8)
    want = jD.GroundingDINOInference(m, params, JaxTinyTokenizer(), image_size=64,
                                     max_dets=7)(image, "a red apple")
    got = tD.GroundingDINOInference(tm, TinyTokenizer(), image_size=64, max_dets=7)(
        image, "a red apple")
    assert set(got) == set(want) and got["label_names"] == want["label_names"]
    assert len(got["bboxes"]) == 7
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL, rtol=0)
    # pixels of a 128-wide image
    np.testing.assert_allclose(np.asarray(got["bboxes"]), np.asarray(want["bboxes"]),
                               atol=128 * ATOL, rtol=0)


# ---- converters --------------------------------------------------------------

def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _converter_case(name):
    """(state dict, reference tree, port state dict, empty port module maker)."""
    from test_convert import make_bert_sd
    from test_convert_diffusion import make_grounding_dino_sd, make_swin_sd

    if name == "bert":
        cfg = jB.bert_test()
        sd = make_bert_sd(cfg, np.random.default_rng(11))
        return (sd, JC.convert_bert_state_dict(sd, cfg), TC.convert_bert_state_dict(sd, cfg),
                lambda: tB.BertModel(tB.bert_test()))
    if name == "bert_no_pooler":
        cfg = jB.bert_test()
        sd = {k[len("bert."):]: v for k, v in make_bert_sd(cfg).items() if "pooler" not in k}
        return (sd, JC.convert_bert_state_dict(sd, cfg), TC.convert_bert_state_dict(sd, cfg),
                lambda: tB.BertModel(tB.bert_test()))
    if name == "swin":
        cfg = jS.swin_test()
        sd = make_swin_sd(cfg, img=64)[0]
        return (sd, JC.convert_swin_state_dict(sd, cfg), TC.convert_swin_state_dict(sd, cfg),
                lambda: tS.SwinTransformer(tS.swin_test()))
    if name == "grounding_dino":
        cfg = jD.grounding_dino_test()
        sd = make_grounding_dino_sd(cfg)[0]
        return (sd, JC.convert_grounding_dino_state_dict(sd, cfg),
                TC.convert_grounding_dino_state_dict(sd, tD.grounding_dino_test()),
                lambda: tD.GroundingDINO(tD.grounding_dino_test()))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["bert", "bert_no_pooler", "swin", "grounding_dino"])
def test_port_converter_matches_reference_bit_for_bit(name):
    sd, ref_tree, port_state, make = _converter_case(name)
    want = load_jax_params(make(), _np_tree(ref_tree))
    got = make()
    got.load_state_dict(port_state, strict=True)
    _assert_same_state(got, want)
    if name == "bert_no_pooler":
        assert not got.pooler.weight.count_nonzero()
    # the inverse: the port state back to the checkpoint's tensors
    rules = {"bert": TC.bert_rules, "bert_no_pooler": TC.bert_rules, "swin": TC.swin_rules,
             "grounding_dino": TC.grounding_dino_rules}[name](sd, make().config)
    back = TC.export_state_dict(rules, port_state)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)


def _manifest(name):
    with open(os.path.join(FIXDIR, f"{name}.txt")) as f:
        return [line for line in f.read().splitlines() if line]


@pytest.mark.parametrize("name", ["bert_base", "swin_t", "grounding_dino_swin_t"])
def test_full_preset_reads_exactly_the_manifest(name):
    keys = set(_manifest(name))
    if name == "bert_base":
        rules_fn, cfg = TC.bert_rules, tB.bert_base()
        module = tB.BertModel(cfg, "meta")
    elif name == "swin_t":
        rules_fn, cfg = TC.swin_rules, tS.swin_tiny()
        module = tS.SwinTransformer(cfg, "meta")
    else:
        rules_fn, cfg = TC.grounding_dino_rules, tD.grounding_dino_tiny()
        module = tD.GroundingDINO(cfg, "meta")
    rules = rules_fn(keys, cfg)
    read = [k for r in rules for k in r.keys]
    filled = [n for r in rules for n in r.names]
    assert len(read) == len(set(read)) and len(filled) == len(set(filled))
    assert set(read) == keys
    assert set(filled) == set(module.state_dict())
    if name == "grounding_dino_swin_t":
        state = module.state_dict()
        assert tuple(state["query_embedding"].shape) == (900, 256)
        assert tuple(state["backbone.stage2_block5.rel_pos_bias"].shape) == (169, 12)
        assert tuple(state["bert.word_embeddings.weight"].shape) == (30522, 768)


def test_grounding_dino_from_checkpoint_file(tmp_path, monkeypatch):
    from spider_tpu_torch.models import checkpoint_io as io

    sd, ref_tree, _, make = _converter_case("grounding_dino")
    path = str(tmp_path / "groundingdino_swint.safetensors")
    io.save_file({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    monkeypatch.setattr(tD, "grounding_dino_tiny", tD.grounding_dino_test)
    infer = factory.from_pretrained("grounding_dino", path=path, device="cpu",
                                    dtype=torch.float32)
    assert isinstance(infer, tD.GroundingDINOInference) and infer.image_size == 512
    _assert_same_state(infer.model, load_jax_params(make(), _np_tree(ref_tree)))
    rand = factory.from_pretrained("grounding_dino", device="cpu", dtype=torch.bfloat16)
    assert rand.model.bert.word_embeddings.weight.dtype == torch.bfloat16
    assert isinstance(rand.tokenizer, TinyTokenizer)


# ---- the entry twin ------------------------------------------------------------

def test_grounding_dino_twin_prints_the_top_boxes():
    out = subprocess.run([sys.executable, "-m", "spider_tpu_torch.grounding_dino_test",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 5 and all(line.startswith("apple: ") for line in lines)
    # the same boxes from the function, and the reference's line format
    from spider_tpu_torch.grounding_dino_test import main

    res = main(["--device", "cpu"])
    assert [f"apple: {s:.3f} {np.round(b, 1).tolist()}"
            for b, s in zip(res["bboxes"], res["scores"])] == lines


def test_grounding_dino_twin_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "spider_tpu_torch.grounding_dino_test"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "--device cpu" in out.stderr


# ---- routing of the grounding callers of ops.attention.attention ---------------

def test_flash_routing_of_the_grounding_and_sam_shapes():
    # chip_smoke.py's unet_routing rows time these shapes on the card; the
    # predicate keeps the one the kernel loses (SAM's token-to-image at batch
    # 1: 8 work items over 4096 keys) on the einsum, and every UNet shape
    # (test_torch_flash_routes.py) where it was
    sys.path.insert(0, ROOT)
    import chip_smoke
    from spider_tpu_torch.ops.attention import spatial_flash_predicate

    routed = {(m, kind): spatial_flash_predicate(B, T, S, H, D)
              for m, _, kind, _, B, T, S, H, D in chip_smoke.grounding_attention_shapes()}
    assert routed == {("grounding_dino_512px", "self"): True,
                      ("sam_vit_h_box", "self"): True,
                      ("sam_vit_h_box", "token_to_image"): False,
                      ("sam_vit_h_box", "image_to_token"): True,
                      ("sam_vit_h_mask_step", "self"): True,
                      ("sam_vit_h_mask_step", "token_to_image"): True,
                      ("sam_vit_h_mask_step", "image_to_token"): True}
    assert chip_smoke.grounding_flash_calls("grounding_dino_512px") == 6
    assert chip_smoke.grounding_flash_calls("sam_vit_h_box") == 4       # 2 self, 2 image-to-token
    assert chip_smoke.grounding_flash_calls("sam_vit_h_mask_step") == 7
