"""The slice end to end: SpiderFree.chat with the tiny JAX models against the
tiny port models on the same weights, plus guards on the port's imports and
on chip_smoke.py.

The chat backbones decode greedily on llama_tiny; both append the same
fixed <IMAGE> span, since a random model never emits tags. The image
decoders run the tiny SD pipelines on the same numpy latents (jax.random and
torch.Generator draw different noise). Tolerance 1e-3 on the image: fp32 on
the CPU through a four-step CFG loop and the VAE decode.
"""

import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.common.config import Config as JaxConfig
from spider_tpu.models import llama as jL
from spider_tpu.models.pipelines import sd as jsd
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu.serving import spider_free as jsf
from spider_tpu_torch.common.config import Config
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import sd as tsd
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from spider_tpu_torch.serving import spider_free as tsf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py")
TAG = " <IMAGE>a running horse on a beach</IMAGE>"
STEPS = 4


def _llama_params(jm):
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))

    def fill(path, s):
        x = 0.05 * rng.standard_normal(s.shape, dtype=np.float32)
        key = jax.tree_util.keystr(path)
        return x + 1.0 if "layernorm" in key or key.endswith("['norm']") else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_image_fn(pipe, latents):
    def image(prompt, **kw):
        cond = pipe.encode_prompt(prompt)
        uncond = pipe.encode_prompt([""] * len(prompt))
        run = pipe._denoise_fn(STEPS, kw["guidance_scale"], latents.shape)
        return pipe._decode_latents(run(pipe.unet_params, latents, cond, uncond,
                                        jax.random.PRNGKey(0)))
    return image


def _torch_image_fn(pipe, latents):
    def image(prompt, **kw):
        return pipe(prompt=prompt, guidance_scale=kw["guidance_scale"],
                    num_inference_steps=STEPS, latents=torch.from_numpy(latents))
    return image


def test_spider_free_chat_matches_jax():
    jtok, ttok = JaxTinyTokenizer(), TinyTokenizer()
    jm = jL.LlamaForCausalLM(jL.llama_tiny())
    params = _llama_params(jm)
    tm = load_jax_params(tL.LlamaForCausalLM(tL.llama_tiny()), params).eval()
    jchat = jsf.make_llama_chat_fn(jm, params, jtok, max_new_tokens=8)
    tchat = tsf.make_llama_chat_fn(tm, ttok, max_new_tokens=8)

    jpipe = jsd.build_tiny_sd(tokenizer=jtok)
    tpipe = tsd.build_tiny_sd(tokenizer=ttok)
    load_jax_params(tpipe.text_encoder, jax.tree_util.tree_map(np.asarray, jpipe.text_params))
    load_jax_params(tpipe.unet, jax.tree_util.tree_map(np.asarray, jpipe.unet_params))
    load_jax_params(tpipe.vae, jax.tree_util.tree_map(np.asarray, jpipe.vae_params))
    latents = np.random.default_rng(1).standard_normal((1, 8, 8, 4), dtype=np.float32)

    jfree = jsf.SpiderFree(JaxConfig.fromfile(CFG), chat_fn=lambda p: jchat(p) + TAG,
                           decoders={"IMAGE": _jax_image_fn(jpipe, latents)})
    tfree = tsf.SpiderFree(Config.fromfile(CFG), chat_fn=lambda p: tchat(p) + TAG,
                           decoders={"IMAGE": _torch_image_fn(tpipe, latents)})
    assert tfree.system_prompt == jfree.system_prompt
    jev, jans, jpred, jtext = jfree.chat("Show me a horse.", task_prompt="IMAGE")
    tev, tans, tpred, ttext = tfree.chat("Show me a horse.", task_prompt="IMAGE")
    assert tans == jans and ttext == jtext
    assert [k for k, _ in tev] == [k for k, _ in jev] == ["text", "image"]
    assert tev[0] == jev[0]
    timg, jimg = tev[1][1]["media"], np.asarray(jev[1][1]["media"])
    assert timg.shape == jimg.shape == (16, 16, 3)
    np.testing.assert_allclose(timg, jimg, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tpred["IMAGE"][0], np.asarray(jpred["IMAGE"][0]), atol=1e-3)


@pytest.mark.parametrize("text", ["<think>x</think>assistant\nDog<BOX>dog</BOX>",
                                  "ASSISTANT: hi", "  plain  "])
def test_prompt_and_answer_helpers_match_jax(text):
    cfg = dict(JaxConfig.fromfile(CFG).model)
    cfg["system_prompt_image"] = " Images welcome."
    assert tsf.build_system_prompt(cfg) == jsf.build_system_prompt(cfg)
    assert tsf.extract_answer(text) == jsf.extract_answer(text)


SLICE_MODULES = [
    "spider_tpu_torch", "spider_tpu_torch.common.registry", "spider_tpu_torch.common.config",
    "spider_tpu_torch.models.tags", "spider_tpu_torch.models.tokenizer",
    "spider_tpu_torch.models.spider_decoder", "spider_tpu_torch.ops.norms",
    "spider_tpu_torch.ops.rope", "spider_tpu_torch.ops.sampling",
    "spider_tpu_torch.ops.attention", "spider_tpu_torch.ops.cuda_build",
    "spider_tpu_torch.models.llama", "spider_tpu_torch.models.decode",
    "spider_tpu_torch.serving.spider_free", "spider_tpu_torch.models.schedulers",
    "spider_tpu_torch.models.clip_text", "spider_tpu_torch.models.vae",
    "spider_tpu_torch.models.unet2d", "spider_tpu_torch.models.pipelines.sd",
    "spider_tpu_torch.models.factory", "spider_tpu_torch.models.convert",
]


def test_port_imports_no_jax():
    # A subprocess: this test process already imported jax (tests/conftest.py).
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'spider_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=120, env=env)
    return out, time.perf_counter() - t0


def test_chip_smoke_refuses_to_run_without_a_gpu():
    build_dir = os.path.join(ROOT, "spider_tpu_torch", "build")
    before = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    out, seconds = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr
    assert seconds < 60
    after = sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else None
    assert after == before          # nothing was built


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out, _ = _run_smoke(str(tmp_path))
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "checkout of the repository" in out.stderr
