#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build    compile the flash-attention kernel (spider_tpu_torch/csrc) with nvcc
  kernel   the kernel against its plain PyTorch version at the slice's shapes
  chat     the 8B int8 Llama (llama3_8b width and depth, random weights from a
           seed) through make_llama_chat_fn: a 128-token prompt, 150 greedy tokens
  request  SpiderFree.chat text+image requests: the 8B chat backbone, tag
           dispatch, SD-1.5 at 512x512 with 40 DDIM steps and CFG 7.5
Then the kernel summary, the card's `nvidia-smi` name and power limit, and
as the last line {"ok": true, "device": {...}}.

A random-weight LLM never emits tags, so the request's chat function
appends a fixed <IMAGE>...</IMAGE> span to the model's real output, standing
in for a trained checkpoint.

It needs a CUDA device and exits non-zero, printing no result, without one
or when any phase fails. TF32 is off for matmuls and convolutions, so the
plain versions compute in full fp32 where they take fp32.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SD_CAPTION = "a running horse on a beach"
PROMPT_TOKENS = 128
NEW_TOKENS = 150
STEPS = 40
GUIDANCE = 7.5
REQUESTS = 3
# Kernel vs plain: bf16 output rounding plus another summation order.
OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
# The bf16 UNet with the kernel may be at most this factor (plus 1e-3) less
# accurate, against an fp32 UNet, than the bf16 UNet with plain attention.
UNET_REL_SLACK = 1.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7) -> float:
    """Median of `reps` warm runs, each timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spider_free_prompt_len(tokenizer) -> int:
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.serving.spider_free import SpiderFree

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, chat_fn=lambda p: "")
    prompt = (f"{sf.system_prompt}\nUser: Show me {SD_CAPTION}."
              f"{SpiderFree.TASK_HINTS['IMAGE']}\nOutput:")
    return len(tokenizer(prompt).input_ids)


def phase_kernel(dev, spider_free_T: int):
    import torch

    from spider_tpu_torch.ops import attention as A

    def inputs(B, T, S, Hq, Hkv, D, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        mk = lambda *s: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16)
        return mk(B, T, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    cases = [
        ("prefill_T128", (1, 128, 128 + NEW_TOKENS, 32, 8, 128),
         dict(causal=True, kv_len=i32(128), q_offset=0)),
        (f"prefill_T{spider_free_T}",
         (1, spider_free_T, spider_free_T + NEW_TOKENS, 32, 8, 128),
         dict(causal=True, kv_len=i32(spider_free_T), q_offset=0)),
        ("unet_self_T4096_D40", (2, 4096, 4096, 8, 8, 40), dict(causal=False)),
        ("unet_cross_T4096_S77_D40", (2, 4096, 77, 8, 8, 40), dict(causal=False)),
        ("ragged_kv_len", (2, 333, 1000, 32, 8, 128),
         dict(causal=False, kv_len=i32(777, 1000))),
    ]
    rows = []
    for i, (name, shape, kw) in enumerate(cases):
        q, k, v = inputs(*shape, seed=100 + i)
        out, lse = A.flash_attention_with_lse(q, k, v, **kw)
        want, want_lse = A.mha_reference_with_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        ms = cuda_ms(lambda: A.flash_attention_with_lse(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: A.mha_reference_with_lse(q, k, v, **kw))
        B, T, S, Hq, Hkv, D = shape
        rows.append(dict(name=name, B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, D=D,
                         causal=kw["causal"], max_abs_err=err, max_abs_err_lse=err_lse,
                         ms=ms, plain_ms=plain_ms, ok=finite and err <= OUT_ATOL
                         and err_lse <= LSE_ATOL))
        del q, k, v, out, lse, want, want_lse
    return rows


def timed_chat(chat_fn, prompt):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = chat_fn(prompt)
    torch.cuda.synchronize()
    return text, time.perf_counter() - t0


def phase_chat(model, tokenizer, spider_free_T: int):
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    prompt = ("Describe a horse running on a beach at sunset. " * 8)[:PROMPT_TOKENS - 1]
    assert len(tokenizer(prompt).input_ids) == PROMPT_TOKENS
    long_prompt = ("x" * (spider_free_T - 1))
    first = make_llama_chat_fn(model, tokenizer, max_new_tokens=1)
    full = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
    timed_chat(first, prompt)                     # warm-up
    before = flash_attention.launches
    prefill_s = min(timed_chat(first, prompt)[1] for _ in range(3))
    prefill_long_s = min(timed_chat(first, long_prompt)[1] for _ in range(3))
    text, total_s = timed_chat(full, prompt)
    launches = flash_attention.launches - before
    decode_s = total_s - prefill_s
    return dict(phase="chat", model="llama3_8b int8 weight-only (random weights)",
                prompt_tokens=PROMPT_TOKENS, new_tokens=NEW_TOKENS,
                prefill_ms_T128=prefill_s * 1e3,
                prefill_ms_T_spider_free=prefill_long_s * 1e3,
                spider_free_prompt_tokens=spider_free_T,
                generate_s=total_s, decode_tok_s=(NEW_TOKENS - 1) / decode_s,
                flash_launches=launches, text_chars=len(text),
                ok=launches > 0 and isinstance(text, str))


def phase_unet_check(pipe, dev):
    """One full-size CFG UNet call in bf16 routed as the main path routes it
    (the kernel at level 0), and the same call with plain bf16 attention
    everywhere, each against an fp32 copy of the UNet with plain attention:
    the kernel inside the real model at its real shapes must be no less
    accurate than the plain path it replaces."""
    import dataclasses

    import torch

    from spider_tpu_torch.models.unet2d import UNet2DConditionModel, spatial_flash_config

    g = torch.Generator(device=dev).manual_seed(7)
    lat = torch.randn((2, 64, 64, 4), generator=g, device=dev)
    ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([SD_CAPTION])])
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ref_unet = UNet2DConditionModel(
        dataclasses.replace(pipe.unet.config, dtype=torch.float32), dev).eval()
    ref_unet.load_state_dict(pipe.unet.state_dict())
    with torch.inference_mode():
        routed = pipe.unet(lat, t, ctx).float()
        with spatial_flash_config("einsum"):
            plain = pipe.unet(lat, t, ctx).float()
            ref = ref_unet(lat, t, ctx.float())
    del ref_unet
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    err_kernel, err_plain = rel(routed), rel(plain)
    return dict(phase="unet_check", rel_err_kernel_vs_fp32=err_kernel,
                rel_err_plain_vs_fp32=err_plain,
                ok=bool(torch.isfinite(routed).all())
                and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)


def phase_request(model, tokenizer, pipe, dev):
    import numpy as np
    import torch

    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    llm_chat = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
    timing = {}

    def chat_fn(prompt):
        text, s = timed_chat(llm_chat, prompt)
        timing["chat_s"] = s
        return text + f" <IMAGE>{SD_CAPTION}</IMAGE>"

    def image_fn(prompt, **kw):
        g = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.synchronize()
        before = flash_attention.launches
        t0 = time.perf_counter()
        img = pipe(prompt=prompt, generator=g, **kw)
        torch.cuda.synchronize()
        timing["image_s"] = time.perf_counter() - t0
        timing["image_launches"] = flash_attention.launches - before
        timing["image_shape"] = list(img.shape)
        timing["image_kw"] = kw
        return img

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, chat_fn=chat_fn, decoders={"IMAGE": image_fn})
    rows = []
    for r in range(REQUESTS):
        timing.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = sf.chat(f"Show me {SD_CAPTION}.", task_prompt="IMAGE")[0]
        total = time.perf_counter() - t0
        kinds = [k for k, _ in events]
        images = [p["media"] for k, p in events if k == "image"]
        img = np.asarray(images[0], np.float32) if images else None
        ok = (kinds[:1] == ["text"] and len(images) == 1
              and timing.get("image_shape") == [1, 512, 512, 3]
              and img.shape == (512, 512, 3) and bool(np.isfinite(img).all())
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0
              and timing.get("image_launches", 0) > 0
              and timing.get("image_kw") == dict(guidance_scale=GUIDANCE,
                                                 num_inference_steps=STEPS))
        rows.append(dict(phase="request", request=r, events=kinds, seconds=total,
                         chat_s=timing.get("chat_s"), image_s=timing.get("image_s"),
                         image_launches=timing.get("image_launches"),
                         image_shape=timing.get("image_shape"),
                         image_min=None if img is None else float(img.min()),
                         image_max=None if img is None else float(img.max()), ok=ok))
    return rows


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        from spider_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU and does "
              "not fall back to the CPU", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ok = True

    # ---- build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.load("flash_fwd")
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=cuda_build.BUILD_SECONDS.get("flash_fwd", 0.0), nvidia_smi=smi,
              tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))

    from spider_tpu_torch.models import factory
    from spider_tpu_torch.ops.attention import flash_attention

    model, tokenizer = factory.from_pretrained("llama", device=dev, seed=0)
    spider_free_T = spider_free_prompt_len(tokenizer)

    # ---- kernel vs plain (these launches are not the main path's)
    rows = phase_kernel(dev, spider_free_T)
    for row in rows:
        emit(dict(phase="kernel", **row))
        ok &= row["ok"]

    pipe = factory.from_pretrained("sd15", device=dev, dtype=torch.bfloat16, seed=0)
    check = phase_unet_check(pipe, dev)
    emit(check)
    ok &= check["ok"]

    # ---- the main path: chat, then text+image requests
    flash_attention.launches = 0
    chat = phase_chat(model, tokenizer, spider_free_T)
    emit(chat)
    ok &= chat["ok"]
    for row in phase_request(model, tokenizer, pipe, dev):
        emit(row)
        ok &= row["ok"]
    launches = flash_attention.launches
    ok &= launches > 0

    sd_row = next(r for r in rows if r["name"] == "unet_self_T4096_D40")
    emit({"kernels": [dict(
        name="flash_fwd", route="cuda", source="spider_tpu_torch/csrc/flash_fwd.cu",
        replaces="spider_tpu/ops/attention.py:67", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=sd_row["ms"],
        plain_ms=sd_row["plain_ms"])]})
    print(smi, flush=True)
    if not ok:
        print("chip_smoke: a phase failed (see the JSON lines above)", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
