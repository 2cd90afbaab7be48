#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build        compile the four kernels (spider_tpu_torch/csrc) with nvcc, in parallel
  kernel       each kernel against its plain PyTorch version at the path's shapes
  unet_check   the SD-1.5 UNet routed through the flash kernel, against fp32
  unet3d_check the ZeroScope UNet3D routed through the temporal kernel, against fp32
  paged_check  one decode chunk of the 8B int8 model over a paged pool, through the
               paged decode kernel and through its plain version
  int4_check   one forward of the 8B int4 model (a 128-token prefill and a 16-slot
               decode step), through the int4 kernel and through its plain version
  chat         the 8B int8 Llama (llama3_8b width and depth, random weights from a
               seed) through make_llama_chat_fn: a 128-token prompt, 150 greedy tokens
  request      SpiderFree.chat text+image requests: the 8B chat backbone, tag
               dispatch, SD-1.5 at 512x512 with 40 DDIM steps and CFG 7.5
  any_to_many  SpiderFree.chat requests that render text, image, audio and video:
               the above plus AudioLDM-l (5 s, 40 steps) and ZeroScope (576x320,
               16 frames, 40 steps); the first is a warm-up, both are printed
  serving      bench_suite.py::bench_paged_serving through the port: 24 mixed-length
               prompts, 48 new tokens each, after 4 warm-up requests, through the
               contiguous batcher (8 slots, int8), the paged batcher (16 slots over
               32 blocks of 128, int8) and the same paged batcher on the int4 model
Then the kernel summary, the card's `nvidia-smi` name and power limit, and
as the last line {"ok": true, "device": {...}}.

Each main-path phase (chat, request, any_to_many, each serving configuration)
sets every kernel's launch count to 0 just before it runs and reads the
counts just after; the kernel
summary's `launches` is their sum. Launches made to compare a kernel with its
plain version are not counted.

A random-weight LLM never emits tags, so the requests' chat function
appends fixed tag spans to the model's real output, standing in for a
trained checkpoint.

It needs a CUDA device and exits non-zero, printing no result, without one
or when any phase fails. It uses cuda:0 only. TF32 is off for matmuls and
convolutions, so the plain versions compute in full fp32 where they take
fp32.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SD_CAPTION = "a running horse on a beach"
AUDIO_CAPTION = "galloping hooves on sand"
VIDEO_CAPTION = "a horse running on a beach"
PROMPT_TOKENS = 128
NEW_TOKENS = 150
STEPS = 40
GUIDANCE = 7.5
REQUESTS = 2
ANY_TO_MANY_REQUESTS = 2
VIDEO_HW_FRAMES = (320, 576, 16)
AUDIO_SECONDS = 5.0
# Kernel vs plain: bf16 output rounding plus another summation order.
OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
# Temporal attention adds bf16's unit roundoff times |plain|: over 16 frames
# an output can pass 4, where one bf16 step is 0.03125.
BF16_EPS = 2.0 ** -8
# A bf16 UNet with a kernel may be at most this factor (plus 1e-3) less
# accurate, against an fp32 UNet, than the bf16 UNet with plain attention.
UNET_REL_SLACK = 1.5
# In-model checks of the serving kernels (paged_check, int4_check): the two
# routes round each layer's attention or projection output to bf16 on either
# side of a rounding edge at times, and the residual stream carries that
# through 32 layers. Random-weight logits have a spread of ~1-2 and a top-2
# gap of ~0.3, so the logits may differ by a few tenths and a few argmaxes
# may flip; a wrong page, mask or nibble moves logits by their own spread
# and leaves ~1/vocab of the argmaxes in agreement.
LOGIT_ATOL = 0.5
AGREE_MIN = 0.75
# int4 kernel vs plain: summation order, then bf16 output rounding (one step
# is 2^-8 relative, so half a step plus one step across an edge).
INT4_REL = 2.0 ** -7
SERVING_REQUESTS = 24
SERVING_NEW_TOKENS = 48
SERVING_WARMUP = 4
KERNELS = ("flash_fwd", "tattn_fwd", "paged_decode", "int4_matmul")


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


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call, without the host's launch cost: the calls are
    queued behind a kernel that sleeps ~20 ms, so the card runs them back to
    back. For kernels shorter than their Python wrapper's host time, which
    cuda_ms then measures instead."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def launch_counters():
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.ops.paged_attention import paged_decode_attention
    from spider_tpu_torch.ops.quant import int4_matmul
    from spider_tpu_torch.ops.temporal_attention import temporal_attention

    return {"flash_fwd": flash_attention, "tattn_fwd": temporal_attention,
            "paged_decode": paged_decode_attention, "int4_matmul": int4_matmul}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def spider_free_prompt_len(tokenizer) -> int:
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.serving.spider_free import SpiderFree

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, chat_fn=lambda p: "")
    prompt = (f"{sf.system_prompt}\nUser: Show me {SD_CAPTION}."
              f"{SpiderFree.TASK_HINTS['IMAGE']}\nOutput:")
    return len(tokenizer(prompt).input_ids)


# ---------------------------------------------------------------------------
# Launch counts the main path must show, from the model configurations
# ---------------------------------------------------------------------------

def flash_launches_per_unet2d_call(cfg, lat_h: int, lat_w: int, ctx_len: int,
                                   batch: int) -> int:
    """Flash launches in one UNet2D call: each transformer block's self- and
    cross-attention where unet2d.spatial_flash_predicate holds."""
    from spider_tpu_torch.models.unet2d import spatial_flash_predicate

    def block(level: int) -> int:
        T = (lat_h >> level) * (lat_w >> level)
        H = cfg.num_attention_heads[level]
        D = cfg.block_out_channels[level] // H
        return (spatial_flash_predicate(batch, T, T, H, D)
                + spatial_flash_predicate(batch, T, ctx_len, H, D))

    n = len(cfg.block_out_channels)
    total = 0
    for lvl in range(n):
        if cfg.cross_attn_blocks[lvl] and cfg.transformer_layers_per_block[lvl] > 0:
            blocks = (2 * cfg.layers_per_block + 1) * cfg.transformer_layers_per_block[lvl]
            total += blocks * block(lvl)
    if cfg.cross_attn_blocks[-1]:
        total += max(cfg.transformer_layers_per_block[-1], 1) * block(n - 1)
    return total


def tattn_launches_per_unet3d_call(cfg, lat_h: int, lat_w: int, frames: int) -> int:
    """Temporal-kernel launches in one UNet3D call: two attentions in each
    TransformerTemporal whose level is inside the kernel's predicate."""
    from spider_tpu_torch.ops.temporal_attention import kernel_predicate

    def tt(level: int) -> int:
        P = (lat_h >> level) * (lat_w >> level)
        return 2 * kernel_predicate(cfg.num_attention_heads[level], frames, P,
                                    cfg.block_out_channels[level])

    n = len(cfg.block_out_channels)
    total = tt(0) + tt(n - 1)                      # transformer_in, mid_tattn
    for lvl in range(n):
        if cfg.cross_attn_blocks[lvl]:
            total += (2 * cfg.layers_per_block + 1) * tt(lvl)   # down + up blocks
    return total


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

def phase_kernel_flash(dev, spider_free_T: int):
    import torch

    from spider_tpu_torch.models.unet2d import _attention, spatial_flash_config
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
        # ZeroScope spatial level 0: routed to the plain einsum by the
        # reference's predicate; measured here only.
        ("zeroscope_self_T2880_D40", (32, 2880, 2880, 8, 8, 40), dict(causal=False)),
        ("audioldm_self_T8192_D16", (2, 8192, 8192, 8, 8, 16), dict(causal=False)),
        ("audioldm_cross_T8192_S1_D16", (2, 8192, 1, 8, 8, 16), dict(causal=False)),
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
        del out, lse, want, want_lse
        ms = cuda_ms(lambda: A.flash_attention_with_lse(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: A.mha_reference_with_lse(q, k, v, **kw))
        B, T, S, Hq, Hkv, D = shape
        row = dict(kernel="flash_fwd", name=name, B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, D=D,
                   causal=kw["causal"], max_abs_err=err, max_abs_err_lse=err_lse, ms=ms,
                   plain_ms=plain_ms, ok=finite and err <= OUT_ATOL and err_lse <= LSE_ATOL)
        if name.startswith("zeroscope"):
            # The plain path the UNet3D really runs there: unet2d's einsum.
            flat = [x.reshape(B, -1, Hq * D) for x in (q, k, v)]
            with spatial_flash_config("einsum"):
                row["unet_einsum_ms"] = cuda_ms(lambda: _attention(*flat, Hq))
            del flat
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_kernel_tattn(dev):
    import torch

    from spider_tpu_torch.ops import temporal_attention as TA

    # (name, B, F, P, C, H, layout): ZeroScope's four levels (CFG batch 2,
    # 16 frames, 8 heads), one pixel-major case and a P that is not a
    # multiple of any pixel tile the kernel picks.
    cases = [("zeroscope_L0_D40", 2, 16, 2880, 320, 8, "bfpc"),
             ("zeroscope_L1_D80", 2, 16, 720, 640, 8, "bfpc"),
             ("zeroscope_L2_D160", 2, 16, 180, 1280, 8, "bfpc"),
             ("zeroscope_mid_D160", 2, 16, 45, 1280, 8, "bfpc"),
             ("bpfc_L1_D80", 2, 16, 720, 640, 8, "bpfc"),
             ("ragged_P1001_D80", 2, 16, 1001, 640, 8, "bfpc")]
    rows = []
    for i, (name, B, F, P, C, H, layout) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        shape = (B, P, F, C) if layout == "bpfc" else (B, F, P, C)
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        out = TA.temporal_attention_kernel(q, k, v, H, layout=layout)
        want = TA.temporal_attention_reference(q, k, v, H, layout=layout)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - (OUT_ATOL + BF16_EPS * want.float().abs())).max().item()
        finite = bool(torch.isfinite(out).all())
        ms = cuda_ms(lambda: TA.temporal_attention_kernel(q, k, v, H, layout=layout))
        plain_ms = cuda_ms(lambda: TA.temporal_attention_reference(q, k, v, H, layout=layout))
        moved = 4 * q.numel() * q.element_size()          # q, k, v read; out written
        rows.append(dict(kernel="tattn_fwd", name=name, B=B, F=F, P=P, C=C, H=H, D=C // H,
                         layout=layout, max_abs_err=err, excess_over_bound=excess,
                         max_abs_plain=want.float().abs().max().item(), ms=ms,
                         plain_ms=plain_ms,
                         gb_per_s=moved / (ms * 1e-3) / 1e9,
                         plain_gb_per_s=moved / (plain_ms * 1e-3) / 1e9,
                         ok=finite and excess <= 0))
        del q, k, v, out, want, diff
    return rows


def phase_kernel_paged(dev):
    import torch

    from spider_tpu_torch.ops import paged_attention as PA

    page, Hq, Hkv, D = 128, 32, 8, 128
    # (name, slots, max_pages, kv_len per slot): the serving shape (16 slots,
    # max_len 512) with lengths at page edges and one past the table; the
    # chat's long context in one slot.
    serving_lens = [1, 127, 128, 129, 512, 4 * page + 5, 300, 2, 255, 256, 257, 384, 511,
                    64, 65, 400]
    cases = [("serving_B16_MP4", 16, 4, serving_lens), ("chat_B1_MP14_len1758", 1, 14, [1758])]
    rows = []
    for i, (name, B, MP, lens) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        n_blocks = B * MP + 1
        q = torch.randn((B, Hq, D), generator=g, device=dev, dtype=torch.bfloat16)
        pk, pv = (torch.randn((n_blocks, page, Hkv, D), generator=g, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        table = (1 + torch.randperm(B * MP, generator=g, device=dev)).reshape(B, MP).int()
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, pk, pv, table, kv_len)
        out = PA.paged_decode_kernel(*args)
        want = PA.paged_decode_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        ms = cuda_ms(lambda: PA.paged_decode_kernel(*args))
        plain_ms = cuda_ms(lambda: PA.paged_decode_reference(*args))
        dev_ms = device_ms(lambda: PA.paged_decode_kernel(*args))
        plain_dev_ms = device_ms(lambda: PA.paged_decode_reference(*args))
        live = sum(min(n, MP * page) for n in lens)
        moved = 2 * live * Hkv * D * 2                     # live K and V bytes read
        rows.append(dict(kernel="paged_decode", name=name, B=B, Hq=Hq, Hkv=Hkv, D=D, page=page,
                         max_pages=MP, kv_len=lens, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                         gb_per_s=moved / (dev_ms * 1e-3) / 1e9,
                         plain_gb_per_s=moved / (plain_dev_ms * 1e-3) / 1e9,
                         ok=finite and err <= OUT_ATOL))
        del q, pk, pv, out, want
    return rows


def phase_kernel_int4(dev):
    import torch

    from spider_tpu_torch.ops import quant as Q

    # llama3_8b's projections (K in, N out); gate and up share a shape.
    shapes = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
              "down": (14336, 4096), "lm_head": (4096, 128256)}
    cases = [(f"{n}_M{M}", M, K, N) for M in (1, 16) for n, (K, N) in shapes.items()]
    cases += [(f"{n}_M{M}", M, *shapes[n]) for M in (128, 1024) for n in ("gate_up", "down")]
    cases.append(("ragged_M37_K4100_N1000", 37, 4100, 1000))
    rows = []
    for i, (name, M, K, N) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(400 + i)
        x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
        packed = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev,
                               dtype=torch.int8)
        scale = torch.full((N,), 1.0 / (4.61 * K ** 0.5), device=dev)
        out = Q.int4_matmul_kernel(x, packed, scale, torch.bfloat16)
        want = Q.int4_matmul_reference(x, packed, scale, torch.bfloat16)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - (1e-3 + INT4_REL * want.float().abs())).max().item()
        finite = bool(torch.isfinite(out).all())
        del out, want, diff
        kernel = lambda: Q.int4_matmul_kernel(x, packed, scale, torch.bfloat16)
        plain = lambda: Q.int4_matmul_reference(x, packed, scale, torch.bfloat16)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        dev_ms, plain_dev_ms = device_ms(kernel), device_ms(plain, calls=5)
        moved = N * K // 2 + 2 * M * K + 2 * M * N     # packed weight, x, out
        rows.append(dict(kernel="int4_matmul", name=name, M=M, K=K, N=N, max_abs_err=err,
                         excess_over_bound=excess, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                         plain_device_ms=plain_dev_ms,
                         gb_per_s=moved / (dev_ms * 1e-3) / 1e9,
                         tflop_per_s=2 * M * K * N / (dev_ms * 1e-3) / 1e12,
                         ok=finite and excess <= 0))
        del x, packed, scale
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the kernels inside the real models
# ---------------------------------------------------------------------------

def _logit_agreement(routed, plain):
    """(max abs difference, share of rows whose argmax agrees, max |plain|)."""
    return ((routed - plain).abs().max().item(),
            (routed.argmax(-1) == plain.argmax(-1)).float().mean().item(),
            plain.abs().max().item())


def phase_paged_check(model, dev):
    """One decode chunk (8 single-token steps) of the 8B int8 model at 16
    slots over one paged pool state, through the paged kernel and through
    paged_decode_reference. Both runs take the same tokens (teacher
    forcing), so every step's logits compare; one slot decodes past its
    4-page table (dropped writes)."""
    import torch

    from spider_tpu_torch.models.llama import init_paged_kv_cache
    from spider_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_config

    cfg = model.config
    S, page, MP, steps = 16, 128, 4, 8
    g = torch.Generator(device=dev).manual_seed(9)
    pool = init_paged_kv_cache(cfg, 1 + S * MP, page, device=dev)
    for p in pool:
        p.normal_(generator=g)
    table = (1 + torch.randperm(S * MP, generator=g, device=dev)).reshape(S, MP).int()
    kv0 = torch.tensor([1, 60, 127, 128, 200, 255, 256, 300, 333, 384, 400, 450, 490, 500,
                        505, 509], dtype=torch.int32, device=dev)
    toks = torch.randint(3, cfg.vocab_size, (steps, S, 1), generator=g, device=dev)

    def chunk():
        state = tuple(p.clone() for p in pool)
        kv, out = kv0.clone(), []
        for t in range(steps):
            logits, _, _ = model(input_ids=toks[t], positions=kv[:, None], kv_write_index=kv,
                                 kv_cache=state, kv_len=kv + 1, page_table=table)
            out.append(logits[:, -1].float())
            kv = kv + 1
        return torch.stack(out)                             # [steps, S, V]

    with torch.inference_mode():
        before = paged_decode_attention.launches
        routed = chunk()
        torch.cuda.synchronize()
        launches = paged_decode_attention.launches - before
        with paged_decode_config("plain"):
            plain = chunk()
    diff, agree, scale = _logit_agreement(routed, plain)
    want = cfg.num_hidden_layers * steps
    ok = (bool(torch.isfinite(routed).all()) and launches == want and diff <= LOGIT_ATOL
          and agree >= AGREE_MIN)
    del pool, routed, plain
    torch.cuda.empty_cache()
    return dict(phase="paged_check", model="llama3_8b int8", slots=S, steps=steps,
                logits_max_abs_diff=diff, logits_max_abs=scale, argmax_agree_share=agree,
                paged_launches=launches, paged_launches_expected=want,
                bounds=dict(logits_atol=LOGIT_ATOL, agree_min=AGREE_MIN), ok=ok)


def phase_int4_check(model, dev):
    """One forward of the 8B int4 model, a 128-token prefill and then a
    16-slot decode step over a contiguous cache, through the int4 kernel
    and through int4_matmul_reference."""
    import torch

    from spider_tpu_torch.models.llama import init_kv_cache
    from spider_tpu_torch.ops.quant import int4_matmul, int4_matmul_config

    cfg = model.config
    S, T = 16, 128
    g = torch.Generator(device=dev).manual_seed(10)
    ids = torch.randint(3, cfg.vocab_size, (1, T), generator=g, device=dev)
    cache = init_kv_cache(cfg, S, T + 8, device=dev)
    for c in cache:
        c.normal_(generator=g)
    kv = torch.randint(1, T, (S,), generator=g, device=dev, dtype=torch.int32)
    tok = torch.randint(3, cfg.vocab_size, (S, 1), generator=g, device=dev)

    def forward():
        prefill = model(input_ids=ids)[0][0].float()                     # [T, V]
        state = tuple(c.clone() for c in cache)
        step = model(input_ids=tok, positions=kv[:, None], kv_write_index=kv,
                     kv_cache=state, kv_len=kv + 1)[0][:, -1].float()   # [S, V]
        return prefill, step

    with torch.inference_mode():
        before = int4_matmul.launches
        routed = forward()
        torch.cuda.synchronize()
        launches = int4_matmul.launches - before
        with int4_matmul_config("plain"):
            plain = forward()
    rows = {}
    ok = launches == 2 * (7 * cfg.num_hidden_layers + 1)
    for name, r, p in zip(("prefill_T128", "decode_S16"), routed, plain):
        diff, agree, scale = _logit_agreement(r, p)
        rows[name] = dict(logits_max_abs_diff=diff, logits_max_abs=scale,
                          argmax_agree_share=agree)
        ok &= bool(torch.isfinite(r).all()) and diff <= LOGIT_ATOL and agree >= AGREE_MIN
    del cache, routed, plain
    torch.cuda.empty_cache()
    return dict(phase="int4_check", model="llama3_8b int4", **rows, int4_launches=launches,
                int4_launches_expected=2 * (7 * cfg.num_hidden_layers + 1),
                bounds=dict(logits_atol=LOGIT_ATOL, agree_min=AGREE_MIN), ok=ok)

def _rel_errors(routed, plain, ref):
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    return rel(routed), rel(plain)


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
    err_kernel, err_plain = _rel_errors(routed, plain, ref)
    return dict(phase="unet_check", rel_err_kernel_vs_fp32=err_kernel,
                rel_err_plain_vs_fp32=err_plain,
                ok=bool(torch.isfinite(routed).all())
                and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)


def phase_unet3d_check(pipe, dev):
    """The same check for the ZeroScope UNet3D at full size (CFG batch 2,
    16 frames, 576x320): temporal attention through the kernel at all four
    levels, then plain, each against an fp32 copy with plain attention."""
    import dataclasses

    import torch

    from spider_tpu_torch.models.unet3d import UNet3DConditionModel
    from spider_tpu_torch.ops.temporal_attention import (temporal_attention,
                                                         temporal_attention_config)

    h, w, frames = VIDEO_HW_FRAMES
    g = torch.Generator(device=dev).manual_seed(8)
    lat = torch.randn((2, frames, h // 8, w // 8, 4), generator=g, device=dev)
    ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([VIDEO_CAPTION])])
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ref_unet = UNet3DConditionModel(
        dataclasses.replace(pipe.unet.config, dtype=torch.float32), dev).eval()
    ref_unet.load_state_dict(pipe.unet.state_dict())
    with torch.inference_mode():
        before = temporal_attention.launches
        routed = pipe.unet(lat, t, ctx).float()
        launches = temporal_attention.launches - before
        with temporal_attention_config("plain"):
            plain = pipe.unet(lat, t, ctx).float()
            ref = ref_unet(lat, t, ctx.float())
    del ref_unet
    torch.cuda.empty_cache()
    err_kernel, err_plain = _rel_errors(routed, plain, ref)
    want = tattn_launches_per_unet3d_call(pipe.unet.config, h // 8, w // 8, frames)
    return dict(phase="unet3d_check", rel_err_kernel_vs_fp32=err_kernel,
                rel_err_plain_vs_fp32=err_plain, tattn_launches=launches,
                tattn_launches_expected=want,
                ok=bool(torch.isfinite(routed).all()) and launches == want
                and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def timed_chat(chat_fn, prompt):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = chat_fn(prompt)
    torch.cuda.synchronize()
    return text, time.perf_counter() - t0


def phase_chat(model, tokenizer, spider_free_T: int):
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    prompt = ("Describe a horse running on a beach at sunset. " * 8)[:PROMPT_TOKENS - 1]
    assert len(tokenizer(prompt).input_ids) == PROMPT_TOKENS
    long_prompt = ("x" * (spider_free_T - 1))
    first = make_llama_chat_fn(model, tokenizer, max_new_tokens=1)
    full = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
    reset_launches()
    timed_chat(first, prompt)                     # warm-up
    prefill_s = min(timed_chat(first, prompt)[1] for _ in range(3))
    prefill_long_s = min(timed_chat(first, long_prompt)[1] for _ in range(3))
    text, total_s = timed_chat(full, prompt)
    launches = read_launches()
    decode_s = total_s - prefill_s
    return dict(phase="chat", model="llama3_8b int8 weight-only (random weights)",
                prompt_tokens=PROMPT_TOKENS, new_tokens=NEW_TOKENS,
                prefill_ms_T128=prefill_s * 1e3,
                prefill_ms_T_spider_free=prefill_long_s * 1e3,
                spider_free_prompt_tokens=spider_free_T,
                generate_s=total_s, decode_tok_s=(NEW_TOKENS - 1) / decode_s,
                launches=launches, text_chars=len(text),
                ok=launches["flash_fwd"] > 0 and isinstance(text, str))


def _timed_decoder(pipe, key: str, timing: dict, seed: int):
    """A SpiderDecoder callable running `pipe` with a seeded generator and
    recording its seconds, output shape, arguments and kernel launches."""
    import numpy as np
    import torch

    def fn(prompt, **kw):
        g = torch.Generator(device=pipe.device).manual_seed(seed)
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        out = pipe(prompt=prompt, generator=g, **kw)
        torch.cuda.synchronize()
        timing[f"{key}_s"] = time.perf_counter() - t0
        timing[f"{key}_launches"] = {n: c - before[n] for n, c in read_launches().items()}
        timing[f"{key}_shape"] = list(out.shape)
        timing[f"{key}_kw"] = kw
        arr = np.asarray(out, np.float32)
        timing[f"{key}_finite"] = bool(np.isfinite(arr).all())
        timing[f"{key}_range"] = [float(arr.min()), float(arr.max())]
        timing[f"{key}_dtype"] = str(out.dtype)
        return out
    return fn


def phase_request(model, tokenizer, pipe):
    import torch

    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    llm_chat = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
    timing = {}

    def chat_fn(prompt):
        text, s = timed_chat(llm_chat, prompt)
        timing["chat_s"] = s
        return text + f" <IMAGE>{SD_CAPTION}</IMAGE>"

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, chat_fn=chat_fn,
                    decoders={"IMAGE": _timed_decoder(pipe, "image", timing, seed=1)})
    want_image = STEPS * flash_launches_per_unet2d_call(pipe.unet.config, 64, 64, 77, 2)
    rows = []
    for r in range(REQUESTS):
        timing.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = sf.chat(f"Show me {SD_CAPTION}.", task_prompt="IMAGE")[0]
        total = time.perf_counter() - t0
        launches = read_launches()
        kinds = [k for k, _ in events]
        images = [p["media"] for k, p in events if k == "image"]
        ok = (kinds == ["text", "image"] and len(images) == 1
              and timing.get("image_shape") == [1, 512, 512, 3]
              and images[0].shape == (512, 512, 3) and timing.get("image_finite")
              and timing["image_range"][0] >= 0.0 and timing["image_range"][1] <= 1.0
              and timing["image_launches"]["flash_fwd"] == want_image
              and timing.get("image_kw") == dict(guidance_scale=GUIDANCE,
                                                 num_inference_steps=STEPS))
        rows.append(dict(phase="request", request=r, events=kinds, seconds=total,
                         chat_s=timing.get("chat_s"), image_s=timing.get("image_s"),
                         image_launches=timing.get("image_launches"),
                         image_launches_expected=want_image,
                         image_shape=timing.get("image_shape"),
                         image_range=timing.get("image_range"), launches=launches, ok=ok))
    return rows


def phase_any_to_many(model, tokenizer, sd, ad, vd):
    import torch

    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models.vocoder import output_length
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    llm_chat = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
    timing = {}
    tags = (f" <IMAGE>{SD_CAPTION}</IMAGE> <AUDIO>{AUDIO_CAPTION}</AUDIO>"
            f" <VIDEO>{VIDEO_CAPTION}</VIDEO>")

    def chat_fn(prompt):
        text, s = timed_chat(llm_chat, prompt)
        timing["chat_s"] = s
        return text + tags

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, chat_fn=chat_fn, decoders={
        "IMAGE": _timed_decoder(sd, "image", timing, seed=1),
        "AUDIO": _timed_decoder(ad, "audio", timing, seed=2),
        "VIDEO": _timed_decoder(vd, "video", timing, seed=3)})

    # What the configurations say the request must show.
    h, w, frames = VIDEO_HW_FRAMES
    lat = ad.latent_shape(1, AUDIO_SECONDS)
    mel_frames = lat[1] * 2 ** (len(ad.vae.config.block_out_channels) - 1)
    want = dict(
        image_flash=STEPS * flash_launches_per_unet2d_call(sd.unet.config, 64, 64, 77, 2),
        audio_flash=STEPS * flash_launches_per_unet2d_call(ad.unet.config, lat[1], lat[2],
                                                           1, 2),
        video_tattn=STEPS * tattn_launches_per_unet3d_call(vd.unet.config, h // 8, w // 8,
                                                           frames),
        audio_shape=[1, output_length(ad.vocoder.config, mel_frames)],
        video_shape=[1, frames, h, w, 3])
    rows = []
    for r in range(ANY_TO_MANY_REQUESTS):
        timing.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = sf.chat(f"Show me {SD_CAPTION}, let me hear it and film it.",
                         task_prompt="SMARTMULTIMODAL")[0]
        total = time.perf_counter() - t0
        launches = read_launches()
        kinds = [k for k, _ in events]
        media = {k: p["media"] for k, p in events if k != "text"}
        ok = (
            # the controller dispatches in its key order: IMAGE, VIDEO, AUDIO
            kinds == ["text", "image", "video", "audio"]
            and timing.get("image_shape") == [1, 512, 512, 3]
            and media["image"].shape == (512, 512, 3) and timing["image_finite"]
            and 0.0 <= timing["image_range"][0] and timing["image_range"][1] <= 1.0
            and timing["image_launches"]["flash_fwd"] == want["image_flash"]
            and timing.get("audio_shape") == want["audio_shape"] and timing["audio_finite"]
            and -1.0 <= timing["audio_range"][0] and timing["audio_range"][1] <= 1.0
            and timing["audio_launches"]["flash_fwd"] == want["audio_flash"]
            and timing.get("audio_kw") == dict(guidance_scale=GUIDANCE,
                                               num_inference_steps=STEPS,
                                               audio_length_in_s=AUDIO_SECONDS)
            and timing.get("video_shape") == want["video_shape"]
            and timing["video_dtype"] == "uint8"
            and timing["video_launches"]["tattn_fwd"] == want["video_tattn"]
            and timing.get("video_kw") == dict(guidance_scale=GUIDANCE,
                                               num_inference_steps=STEPS, height=h, width=w,
                                               num_frames=frames))
        rows.append(dict(
            phase="any_to_many", request=r, warm_up=r == 0, events=kinds, seconds=total,
            chat_s=timing.get("chat_s"), image_s=timing.get("image_s"),
            audio_s=timing.get("audio_s"), video_s=timing.get("video_s"),
            image_launches=timing.get("image_launches"),
            audio_launches=timing.get("audio_launches"),
            video_launches=timing.get("video_launches"), expected=want,
            audio_shape=timing.get("audio_shape"), audio_range=timing.get("audio_range"),
            video_shape=timing.get("video_shape"), video_dtype=timing.get("video_dtype"),
            launches=launches, ok=ok))
    return rows


def serving_prompts(n: int):
    """bench_suite.py::bench_paged_serving's mixed-length prompts."""
    words = ["horse", "beach", "run", "paint", "sky", "song", "red", "cat"]
    return [" ".join(words[(i * 3) % 8:] * ((i % 7) + 1))[: 40 * ((i % 6) + 1)]
            for i in range(n)]


def _greedy_tokens(model, tokenizer, prompts, n):
    """A standalone greedy generate of each prompt (one right-padded batch):
    token ids without pads."""
    import torch

    from spider_tpu_torch.models.decode import GenerateConfig, generate

    ids = [tokenizer(p, add_special_tokens=True).input_ids for p in prompts]
    T = max(len(i) for i in ids)
    arr = torch.tensor([i + [tokenizer.pad_token_id] * (T - len(i)) for i in ids],
                       device=model.device)
    with torch.inference_mode():
        emb = model.embed(arr)
    out = generate(model, emb, torch.tensor([len(i) for i in ids], dtype=torch.int32),
                   GenerateConfig(max_new_tokens=n, eos_ids=(tokenizer.eos_token_id,),
                                  pad_id=tokenizer.pad_token_id))
    return [[t for t in row if t != tokenizer.pad_token_id]
            for row in out["tokens"].tolist()]


def phase_serving(model8, model4, tokenizer):
    """bench_suite.py::bench_paged_serving through the port: for each batcher,
    4 warm-up requests, then 24 timed ones (tok/s = 24 * 48 / seconds, as
    there); the launch counts are zeroed just before the timed requests and
    read just after."""
    import torch

    from spider_tpu_torch.serving.continuous import ContinuousBatcher, PagedContinuousBatcher

    prompts = serving_prompts(SERVING_REQUESTS)
    n_new = SERVING_NEW_TOKENS
    configs = [
        ("contiguous_bs8_int8", model8,
         lambda m: ContinuousBatcher(m, tokenizer, num_slots=8, max_len=512,
                                     max_new_tokens=n_new)),
        ("paged_bs16_int8", model8,
         lambda m: PagedContinuousBatcher(m, tokenizer, num_slots=16, max_len=512,
                                          max_new_tokens=n_new, page=128, num_blocks=32)),
        ("paged_bs16_int4", model4,
         lambda m: PagedContinuousBatcher(m, tokenizer, num_slots=16, max_len=512,
                                          max_new_tokens=n_new, page=128, num_blocks=32)),
    ]
    rows = []
    for name, model, make in configs:
        cfg = model.config
        cb = make(model)
        # Record each finished request's token ids, for the parity report.
        emitted = {}
        finish = cb._finish

        def record(slot, cb=cb, finish=finish, emitted=emitted):
            req = cb._requests[slot]
            finish(slot)
            emitted[id(req.future)] = list(req.emitted)

        cb._finish = record
        warm = [f.result(timeout=600) for f in [cb.submit(p) for p in prompts[:SERVING_WARMUP]]]
        steps0, prefills0 = cb.n_decode_steps, cb.n_prefills
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        futs = [cb.submit(p) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        seconds = time.perf_counter() - t0
        launches = read_launches()
        steps, prefills = cb.n_decode_steps - steps0, cb.n_prefills - prefills0
        cb.close()
        alive = cb._thread.is_alive()
        paged = isinstance(cb, PagedContinuousBatcher)
        drained = sorted(cb._free) == list(range(1, 33)) if paged else True
        want = dict(
            flash_fwd=cfg.num_hidden_layers * prefills,
            paged_decode=cfg.num_hidden_layers * steps if paged else 0,
            # 7 projections a layer and the lm_head, in every decode step and
            # every prefill (each prefill bucket is at most 512 rows)
            int4_matmul=((7 * cfg.num_hidden_layers + 1) * (steps + prefills)
                         if cfg.quantization == "int4" else 0),
            tattn_fwd=0)
        got = [emitted[id(f)] for f in futs[:SERVING_WARMUP]]
        ref = _greedy_tokens(model, tokenizer, prompts[:SERVING_WARMUP], n_new)
        leading = []
        for a, b in zip(got, ref):
            n = 0
            while n < min(len(a), len(b)) and a[n] == b[n]:
                n += 1
            leading.append(n)
        ok = (all(isinstance(o, str) for o in warm + outs) and drained and not alive
              and launches == want)
        rows.append(dict(
            phase="serving", config=name, model=f"llama3_8b {cfg.quantization}",
            requests=SERVING_REQUESTS, new_tokens=n_new, seconds=seconds,
            tok_s=SERVING_REQUESTS * n_new / seconds,
            emitted_tokens=sum(len(emitted[id(f)]) for f in futs),
            decode_steps=steps, prefills=prefills,
            n_preempts=getattr(cb, "n_preempts", None), pool_drained=drained,
            launches=launches, launches_expected=want,
            leading_tokens_equal_generate=leading, ok=ok))
        del cb
        torch.cuda.empty_cache()
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

    # ---- build: one nvcc per kernel source, all started together
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.load_all(KERNELS)
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds={k: cuda_build.BUILD_SECONDS.get(k, 0.0) for k in KERNELS},
              nvidia_smi=smi, tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))

    from spider_tpu_torch.models import factory

    model, tokenizer = factory.from_pretrained("llama", device=dev, seed=0)
    spider_free_T = spider_free_prompt_len(tokenizer)

    # ---- kernel vs plain (these launches are not the main path's)
    rows = (phase_kernel_flash(dev, spider_free_T) + phase_kernel_tattn(dev)
            + phase_kernel_paged(dev) + phase_kernel_int4(dev))
    for row in rows:
        emit(dict(phase="kernel", **row))
        ok &= row["ok"]

    model4, _ = factory.from_pretrained("llama", device=dev, seed=0, quantization="int4")
    for check in (phase_paged_check(model, dev), phase_int4_check(model4, dev)):
        emit(check)
        ok &= check["ok"]

    sd = factory.from_pretrained("sd15", device=dev, dtype=torch.bfloat16, seed=0)
    check = phase_unet_check(sd, dev)
    emit(check)
    ok &= check["ok"]
    vd = factory.from_pretrained("zeroscope", device=dev, dtype=torch.bfloat16, seed=1)
    check = phase_unet3d_check(vd, dev)
    emit(check)
    ok &= check["ok"]
    ad = factory.from_pretrained("audioldm", device=dev, dtype=torch.bfloat16, seed=2)

    # ---- the main path: chat, text+image requests, any-to-many requests,
    # continuous-batching serving; each phase zeroes the counts before it
    # runs and reads them after.
    main_launches = dict.fromkeys(KERNELS, 0)
    phases = [phase_chat(model, tokenizer, spider_free_T)]
    phases += phase_request(model, tokenizer, sd)
    phases += phase_any_to_many(model, tokenizer, sd, ad, vd)
    phases += phase_serving(model, model4, tokenizer)
    for row in phases:
        emit(row)
        ok &= row["ok"]
        for name in KERNELS:
            main_launches[name] += row["launches"][name]
    ok &= all(n > 0 for n in main_launches.values())

    by_name = {r["name"]: r for r in rows}
    flash_row, tattn_row = by_name["unet_self_T4096_D40"], by_name["zeroscope_L0_D40"]
    paged_row, int4_row = by_name["serving_B16_MP4"], by_name["gate_up_M16"]
    emit({"kernels": [
        dict(name="flash_fwd", route="cuda", source="spider_tpu_torch/csrc/flash_fwd.cu",
             replaces="spider_tpu/ops/attention.py:67", launches=main_launches["flash_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == "flash_fwd"),
             ms=flash_row["ms"], plain_ms=flash_row["plain_ms"]),
        dict(name="tattn_fwd", route="cuda", source="spider_tpu_torch/csrc/tattn_fwd.cu",
             replaces="spider_tpu/ops/temporal_attention.py:45",
             launches=main_launches["tattn_fwd"],
             max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == "tattn_fwd"),
             ms=tattn_row["ms"], plain_ms=tattn_row["plain_ms"]),
        dict(name="paged_decode", route="cuda", source="spider_tpu_torch/csrc/paged_decode.cu",
             replaces="spider_tpu/ops/paged_attention.py:31",
             launches=main_launches["paged_decode"],
             max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == "paged_decode"),
             ms=paged_row["ms"], plain_ms=paged_row["plain_ms"]),
        dict(name="int4_matmul", route="cuda", source="spider_tpu_torch/csrc/int4_matmul.cu",
             replaces="spider_tpu/ops/quant.py:65", launches=main_launches["int4_matmul"],
             max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == "int4_matmul"),
             ms=int4_row["ms"], plain_ms=int4_row["plain_ms"])]})
    print(smi, flush=True)
    if not ok:
        print("chip_smoke: a phase failed (see the JSON lines above)", file=sys.stderr)
        return 1
    # The run uses one device, cuda:0, whatever else the machine shows.
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
