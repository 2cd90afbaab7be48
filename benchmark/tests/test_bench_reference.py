"""The reference against the port at a tiny size on the CPU (fp32, the same
weights), and its parameter names and shapes against the port's modules at
the cells' full sizes (meta device)."""

import json
import os

import pytest
import torch

from benchmark import cells, weights
from benchmark.reference import build, ddim, tokenizer

DATA = os.path.join(os.path.dirname(__file__), "data")


def _tiny(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def _port_pipeline(kind):
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

    return build_tiny_sd(device="cpu") if kind == "sd" else build_tiny_vd(device="cpu")


def _filled(pipe, cfg, seed=7):
    mods = {"text_encoder": pipe.text_encoder, "unet": pipe.unet, "vae": pipe.vae}
    specs = weights.module_specs(mods)
    values = weights.fill(specs, seed, "cpu", torch.float32)
    weights.load_into(mods, values)
    text, unet, vae = build.models(cfg, "cpu")
    for m, prefix in ((text, "text_encoder"), (unet, "unet"), (vae, "vae")):
        build.load(m, prefix, values)
    return text, unet, vae


@pytest.mark.parametrize("kind", ["sd", "vd"])
def test_reference_equals_the_port_at_a_tiny_size(kind):
    cfg = _tiny(f"tiny_{kind}")
    pipe = _port_pipeline(kind)
    text, unet, vae = _filled(pipe, cfg)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ids = torch.tensor(tokenizer.batch_ids(["", "a red fox in snow"]))
        assert torch.equal(ids, pipe.tokenize(["", "a red fox in snow"]))
        ctx = pipe.text_encoder(ids)[0]
        torch.testing.assert_close(text(ids), ctx, rtol=1e-5, atol=1e-5)
        shape = (2, 4, 8, 8, 4) if kind == "vd" else (2, 8, 8, 4)
        lat = torch.randn(shape, generator=g)
        t = torch.tensor([981, 981])
        torch.testing.assert_close(unet(lat, t, ctx), pipe.unet(lat, t, ctx),
                                   rtol=1e-4, atol=1e-5)
        z = torch.randn((3, 8, 8, 4), generator=g)
        torch.testing.assert_close(vae(z), pipe.vae.decode(z), rtol=1e-4, atol=1e-5)


def test_ddim_equals_the_port_scheduler():
    from spider_tpu_torch.models.schedulers import DDIMScheduler

    sched = _tiny("tiny_sd")["scheduler"]
    port = DDIMScheduler()
    assert ddim.timesteps(sched, 40) == port.timesteps(40)
    g = torch.Generator().manual_seed(5)
    x, eu, ec = (torch.randn(1, 8, 8, 4, generator=g) for _ in range(3))
    for t in (976, 26, 1):
        want = port.step(eu + 7.5 * (ec - eu), t, x, 40)
        torch.testing.assert_close(ddim.guided_step(sched, 40, t, x, eu, ec, 7.5), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", ["zeroscope_576w", "sd15"])
def test_full_size_names_and_shapes_match_the_port(config):
    from spider_tpu_torch.models.factory import pipeline_parts

    cfg = cells.load_config(config)
    parts = pipeline_parts(cfg["pipeline"], device="meta")
    text, unet, vae = build.models(cfg, "meta")
    port = {f"{p}.{k}": tuple(v.shape) for p, (m, _) in parts.items()
            for k, v in m.state_dict().items()}
    ref = {f"{p}.{k}": tuple(v.shape) for p, m in (("text_encoder", text), ("unet", unet),
                                                    ("vae", vae))
           for k, v in m.state_dict().items()}
    assert set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    # what the reference leaves out is the VAE's encoder, which no request runs
    assert {k.split(".")[1] for k in set(port) - set(ref)} == {"encoder"}


def test_norms_are_filled_with_ones_and_zeros():
    vals = weights.fill({"a.norm1.weight": (4,), "a.norm1.bias": (4,), "a.conv1.weight": (4, 4),
                         "layers_0.layer_norm2.bias": (3,)}, 11, "cpu", torch.bfloat16)
    assert torch.equal(vals["a.norm1.weight"], torch.ones(4, dtype=torch.bfloat16))
    assert not vals["a.norm1.bias"].any() and not vals["layers_0.layer_norm2.bias"].any()
    assert 0.005 < float(vals["a.conv1.weight"].float().std()) < 0.05
    again = weights.fill({"a.norm1.weight": (4,), "a.norm1.bias": (4,), "a.conv1.weight": (4, 4),
                          "layers_0.layer_norm2.bias": (3,)}, 11, "cpu", torch.bfloat16)
    assert torch.equal(vals["a.conv1.weight"], again["a.conv1.weight"])


def test_derived_seeds_take_large_and_negative_numbers():
    a = weights.derive_seed(2 ** 33 + 7, -1)
    assert 0 <= a < 2 ** 63 and a != weights.derive_seed(2 ** 33 + 7, 1)
    torch.Generator().manual_seed(a)
