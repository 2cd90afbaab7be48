"""Grounding DINO and SAM in bf16 on the card, their attentions on the flash
kernel, against the same weights in fp32 with plain attention.

These tests need an NVIDIA GPU: the flash kernel has no CPU mode, so without
a card they skip. They import torch only:
``python -m pytest --noconftest tests/test_torch_grounding_cuda.py``.

The rule is ``chip_smoke.py``'s ``grounding_check`` and ``mask_check``: the
bf16 model routed through the kernel may be at most 1.5x (plus 1e-3) less
accurate, against fp32, than the bf16 model with plain attention. At the
test widths (``grounding_dino_test`` at 64 px, ``sam_tiny``) with the
attention widened to the real head dims (D 32 and 16) so that the calls take
the kernel's bf16 route.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spider_tpu_torch.models import dino as tD
from spider_tpu_torch.models import sam as tSam
from spider_tpu_torch.models.factory import random_init_
from spider_tpu_torch.ops.attention import spatial_flash_config
from spider_tpu_torch.ops.attention import flash_attention

pytestmark = pytest.mark.cuda
REL_SLACK = 1.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _held(routed, plain, ref):
    assert torch.isfinite(routed.float()).all()
    assert _rel(routed, ref) <= REL_SLACK * _rel(plain, ref) + 1e-3, (_rel(routed, ref),
                                                                      _rel(plain, ref))


def _launches():
    return flash_attention.launches, flash_attention.route_launches.get("wgmma", 0)


def test_grounding_dino_on_the_kernel_matches_fp32(dev):
    # hidden 128 over 4 heads: the decoder's self-attention at D 32
    cfg = dataclasses.replace(tD.grounding_dino_test(), hidden_dim=128)
    ref = random_init_(tD.GroundingDINO(cfg, dev).eval(), torch.Generator(device=dev).manual_seed(0))
    model = tD.GroundingDINO(tD.with_dtype(cfg, torch.bfloat16), dev).eval()
    model.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((1, 3, 64, 64), dtype=np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(1, 300, (1, 16))).to(dev)
    mask = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    mask[0, :9] = 1
    flat = lambda o: torch.cat([o["boxes"].flatten(), o["scores"].float().flatten()])
    with torch.inference_mode():
        before = _launches()
        routed = model(img, ids, mask)
        after = _launches()
        with spatial_flash_config("einsum"):
            plain = model(img, ids, mask)
            want = ref(img, ids, mask)
    assert after[0] - before[0] == cfg.dec_layers == after[1] - before[1]   # all on wgmma
    _held(flat(routed), flat(plain), flat(want))


@pytest.mark.parametrize("prompt", ["box", "text"])
def test_sam_on_the_kernel_matches_fp32(dev, prompt):
    # prompt width 256 over 8 heads: D 32 and 16, as SAM ViT-H's mask decoder
    cfg = dataclasses.replace(tSam.sam_tiny(), prompt_embed_dim=256)
    ref = random_init_(tSam.Sam(cfg, dev).eval(), torch.Generator(device=dev).manual_seed(1))
    model = tSam.Sam(dataclasses.replace(cfg, dtype=torch.bfloat16), dev).eval()
    model.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((2, 3, 64, 64), dtype=np.float32)).to(dev)
    if prompt == "box":
        kw = dict(boxes=torch.tensor([[[4.0, 6.0, 50.0, 40.0]], [[10.0, 2.0, 30.0, 60.0]]],
                                     device=dev))
    else:
        kw = dict(text_embeds=torch.from_numpy(
            rng.standard_normal((2, 1, 256), dtype=np.float32)).to(dev))
    with torch.inference_mode():
        before = _launches()
        routed = model(img, **kw)
        after = _launches()
        with spatial_flash_config("einsum"):
            plain = model(img, **kw)
            want = ref(img, **kw)
    assert after[0] - before[0] == 7 == after[1] - before[1]      # 2 + 3 + 2 attentions
    _held(routed, plain, want)


def test_mask_decoder_gradients_through_the_kernels(dev):
    # the MASK train step's form: fp32 decoder parameters computing in bf16,
    # gradients through the flash backward against the plain backward's
    from spider_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(tSam.sam_tiny(), prompt_embed_dim=256, dtype=torch.bfloat16)
    sam = random_init_(tSam.Sam(cfg, dev), torch.Generator(device=dev).manual_seed(2))
    sam.mask_decoder.float()
    img = torch.randn((4, 3, 64, 64), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    text = torch.randn((4, 1, 256), generator=torch.Generator(device=dev).manual_seed(4), device=dev)

    def grads():
        sam.zero_grad(set_to_none=True)
        sam.predict_text(img, text).float().square().mean().backward()
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                          for p in sam.mask_decoder.parameters()])

    dq = A.flash_bwd_dq.route_launches.get("wgmma", 0)
    g_k = grads()
    assert A.flash_bwd_dq.route_launches["wgmma"] - dq == 7
    kernel_backward = A.flash_backward
    A.flash_backward = (lambda q, k, v, out, lse, g, route=None, **kw:
                        A.flash_backward_reference(q, k, v, out, lse, g, **kw))
    try:
        g_p = grads()
    finally:
        A.flash_backward = kernel_backward
    assert torch.isfinite(g_k).all() and g_p.norm() > 0
    assert _rel(g_k, g_p) <= 5e-2
    assert torch.nn.functional.cosine_similarity(g_k, g_p, dim=0) >= 0.999
