"""The slice end to end: SpiderFree.chat with the tiny JAX models against the
tiny port models on the same weights, plus guards on the port's imports and
on chip_smoke.py.

The chat backbones decode greedily on llama_tiny; both append the same
fixed tag spans, since a random model never emits tags. The decoders run the
tiny SD, AudioLDM and ZeroScope pipelines on the same numpy latents
(jax.random and torch.Generator draw different noise). Tolerance 1e-3 on the
image and the waveform: fp32 on the CPU through a four-step CFG loop and the
decode; 1 on the uint8 video frames (a value next to a rounding step may
truncate either way).
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
from spider_tpu.models.pipelines import ad as jad
from spider_tpu.models.pipelines import sd as jsd
from spider_tpu.models.pipelines import vd as jvd
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu.serving import spider_free as jsf
from spider_tpu_torch.common.config import Config
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import ad as tad
from spider_tpu_torch.models.pipelines import sd as tsd
from spider_tpu_torch.models.pipelines import vd as tvd
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


def _jax_audio_fn(pipe, latents):
    def audio(prompt, **kw):
        cond = pipe.encode_prompt(prompt)
        uncond = pipe.encode_prompt([""] * len(prompt))
        lat = pipe._denoise_fn(STEPS, kw["guidance_scale"], latents.shape)(
            pipe.unet_params, latents, cond, uncond, jax.random.PRNGKey(0))
        mel = pipe.vae.apply(pipe.vae_params, lat, method=pipe.vae.decode)[..., 0]
        return np.asarray(pipe.vocoder.apply(pipe.vocoder_params, mel))
    return audio


def _jax_video_fn(pipe, latents):
    def video(prompt, **kw):
        cond = pipe.encode_prompt(prompt)
        uncond = pipe.encode_prompt([""] * len(prompt))
        lat = pipe._denoise_fn(STEPS, kw["guidance_scale"], latents.shape)(
            pipe.unet_params, latents, cond, uncond, jax.random.PRNGKey(0))
        B, F = latents.shape[:2]
        img = pipe.vae.apply(pipe.vae_params, lat.reshape(B * F, *latents.shape[2:]),
                             method=pipe.vae.decode)
        frames = ((img / 2 + 0.5).clip(0.0, 1.0) * 255.0).astype(jnp.uint8)
        return np.asarray(frames).reshape(B, F, *frames.shape[1:])
    return video


def _load_pipe(tpipe, jpipe):
    """Carry a JAX tiny pipeline's weights into the port's counterpart."""
    for mod, params in (("text_encoder", "text_params"), ("unet", "unet_params"),
                        ("vae", "vae_params"), ("vocoder", "vocoder_params")):
        if hasattr(jpipe, params):
            load_jax_params(getattr(tpipe, mod),
                            jax.tree_util.tree_map(np.asarray, getattr(jpipe, params)))
    return tpipe


def test_spider_free_chat_matches_jax():
    jtok, ttok = JaxTinyTokenizer(), TinyTokenizer()
    jm = jL.LlamaForCausalLM(jL.llama_tiny())
    params = _llama_params(jm)
    tm = load_jax_params(tL.LlamaForCausalLM(tL.llama_tiny()), params).eval()
    jchat = jsf.make_llama_chat_fn(jm, params, jtok, max_new_tokens=8)
    tchat = tsf.make_llama_chat_fn(tm, ttok, max_new_tokens=8)

    jpipe = jsd.build_tiny_sd(tokenizer=jtok)
    tpipe = _load_pipe(tsd.build_tiny_sd(tokenizer=ttok, device="cpu"), jpipe)
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


ANY_TAGS = (" <IMAGE>a running horse on a beach</IMAGE> <AUDIO>galloping hooves on sand"
            "</AUDIO> <VIDEO>a horse running on a beach</VIDEO>")


def test_spider_free_any_to_many_matches_jax():
    """One chat turn that renders text, image, audio and video."""
    jtok, ttok = JaxTinyTokenizer(), TinyTokenizer()
    jm = jL.LlamaForCausalLM(jL.llama_tiny())
    params = _llama_params(jm)
    tm = load_jax_params(tL.LlamaForCausalLM(tL.llama_tiny()), params).eval()
    jchat = jsf.make_llama_chat_fn(jm, params, jtok, max_new_tokens=4)
    tchat = tsf.make_llama_chat_fn(tm, ttok, max_new_tokens=4)
    j_sd, j_ad, j_vd = (b(tokenizer=jtok) for b in (jsd.build_tiny_sd, jad.build_tiny_ad,
                                                    jvd.build_tiny_vd))
    t_sd = _load_pipe(tsd.build_tiny_sd(tokenizer=ttok, device="cpu"), j_sd)
    t_ad = _load_pipe(tad.build_tiny_ad(tokenizer=ttok, device="cpu"), j_ad)
    t_vd = _load_pipe(tvd.build_tiny_vd(tokenizer=ttok, device="cpu"), j_vd)
    rng = np.random.default_rng(2)
    img_lat = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    aud_lat = rng.standard_normal(t_ad.latent_shape(1, 0.1), dtype=np.float32)
    vid_lat = rng.standard_normal((1, 3, 8, 8, 4), dtype=np.float32)

    def t_audio(prompt, **kw):
        return t_ad(prompt=prompt, guidance_scale=kw["guidance_scale"],
                    num_inference_steps=STEPS, audio_length_in_s=0.1,
                    latents=torch.from_numpy(aud_lat))

    def t_video(prompt, **kw):
        assert (kw["height"], kw["width"], kw["num_frames"]) == (320, 576, 16)
        return t_vd(prompt=prompt, guidance_scale=kw["guidance_scale"],
                    num_inference_steps=STEPS, height=16, width=16, num_frames=3,
                    latents=torch.from_numpy(vid_lat))

    jfree = jsf.SpiderFree(JaxConfig.fromfile(CFG), chat_fn=lambda p: jchat(p) + ANY_TAGS,
                           decoders={"IMAGE": _jax_image_fn(j_sd, img_lat),
                                     "AUDIO": _jax_audio_fn(j_ad, aud_lat),
                                     "VIDEO": _jax_video_fn(j_vd, vid_lat)})
    tfree = tsf.SpiderFree(Config.fromfile(CFG), chat_fn=lambda p: tchat(p) + ANY_TAGS,
                           decoders={"IMAGE": _torch_image_fn(t_sd, img_lat),
                                     "AUDIO": t_audio, "VIDEO": t_video})
    jev, jans, _, jtext = jfree.chat("Show, play and film a horse.",
                                     task_prompt="SMARTMULTIMODAL")
    tev, tans, _, ttext = tfree.chat("Show, play and film a horse.",
                                     task_prompt="SMARTMULTIMODAL")
    assert tans == jans and ttext == jtext
    # The controller dispatches in its own key order: IMAGE, VIDEO, AUDIO.
    assert [k for k, _ in tev] == [k for k, _ in jev] == ["text", "image", "video", "audio"]
    got, want = dict(tev), dict(jev)
    assert got["text"] == want["text"]
    np.testing.assert_allclose(got["image"]["media"], np.asarray(want["image"]["media"]),
                               atol=1e-3, rtol=0)
    assert got["audio"]["media"].shape == np.asarray(want["audio"]["media"]).shape == (48,)
    np.testing.assert_allclose(got["audio"]["media"], np.asarray(want["audio"]["media"]),
                               atol=1e-3, rtol=0)
    tvid, jvid = got["video"]["media"], np.asarray(want["video"]["media"])
    assert tvid.dtype == jvid.dtype == np.uint8 and tvid.shape == jvid.shape == (1, 3, 16, 16, 3)
    assert np.abs(tvid.astype(np.int16) - jvid.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("text", ["<think>x</think>assistant\nDog<BOX>dog</BOX>",
                                  "ASSISTANT: hi", "  plain  "])
def test_prompt_and_answer_helpers_match_jax(text):
    cfg = dict(JaxConfig.fromfile(CFG).model)
    cfg["system_prompt_image"] = " Images welcome."
    assert tsf.build_system_prompt(cfg) == jsf.build_system_prompt(cfg)
    assert tsf.extract_answer(text) == jsf.extract_answer(text)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "spider_tpu")


def test_port_imports_no_jax():
    # Every module of the package, spider_tpu_torch.train included, in a
    # subprocess: this test process already imported jax (tests/conftest.py).
    code = ("import importlib, pkgutil, sys\n"
            "import spider_tpu_torch\n"
            "names = ['spider_tpu_torch'] + [m.name for m in pkgutil.walk_packages("
            "spider_tpu_torch.__path__, 'spider_tpu_torch.')]\n"
            "assert 'spider_tpu_torch.train' in names and len(names) > 50, names\n"
            "assert {'spider_tpu_torch.models.sam', 'spider_tpu_torch.models.dino', "
            "'spider_tpu_torch.ops.msda', 'spider_tpu_torch.grounding_dino_test', "
            "'spider_tpu_torch.spider_decoder_infer', 'spider_tpu_torch.models.qwen_omni', "
            "'spider_tpu_torch.models.omni_talker', 'spider_tpu_torch.models.omni_token2wav', "
            "'spider_tpu_torch.models.omni_speech', 'spider_tpu_torch.qwen2_5omni_infer', "
            "'spider_tpu_torch.qwen2_5omni_web', 'spider_tpu_torch.qwen2_5omni_spider_web', "
            "'spider_tpu_torch.datasets.flac', 'spider_tpu_torch.datasets.media', "
            "'spider_tpu_torch.datasets.native_loader', 'spider_tpu_torch.datasets.refer', "
            "'spider_tpu_torch.datasets.grounding', 'spider_tpu_torch.datasets.story', "
            "'spider_tpu_torch.datasets.travel_guide', 'spider_tpu_torch.datasets.shard_writer', "
            "'spider_tpu_torch.processors.randaugment', 'spider_tpu_torch.common.gradcam', "
            "'spider_tpu_torch.common.observability', 'spider_tpu_torch.common.profiler'} "
            "<= set(names), names\n"
            "for m in names: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_no_jax_import():
    # Imports made inside functions never reach sys.modules above: read the
    # sources of the package and of chip_smoke.py.
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "spider_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(paths) > 50
    for path in paths:
        with open(path) as f:
            found = pattern.findall(f.read())
        assert not found, (path, found)


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
