#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build        compile the kernel sources (spider_tpu_torch/csrc) with nvcc, in
               parallel; spills and ptxas's wgmma warnings from the kept logs
  wgmma_probe  single wgmma products (csrc/wgmma_probe.cu) against torch.matmul
  kernel       each kernel against its plain PyTorch version at the path's shapes,
               with its bound on this card and, where one PyTorch call computes the
               same function, that call's time (timed here, used nowhere in the port).
               The flash forward, dq and dk/dv rows run both routes of
               ops/attention.py::flash_route on the same inputs: `ms`/`device_ms` are
               the route the rule names, `previous_ms`/`previous_device_ms` the
               general mma.sync route; the temporal rows likewise for
               ops/temporal_attention.py::tattn_route ("ring", and "simple" before it),
               the paged rows for ops/paged_attention.py::paged_route ("split", and
               "simple" before it) and the int4 rows for ops/quant.py::int4_route
               ("stream" up to 16 rows with K/2 <= 2048, "wgmma" from 48 rows, and
               "mma" before them, which keeps down at up to 16 rows); each
               new serving route runs twice and must give the same bits
  int4_crossover  the int4 "mma" and "wgmma" kernels side by side at 17 to 64 rows: the
               rows ops/quant.py::WGMMA_MIN_M is read from
  wrapper_us   host microseconds a call of the two serving wrappers over 1000 queued
               calls, no synchronise inside
  floors       the redesigned routes against the ones they replaced, on device time
  tattn_grad   gradients through temporal_attention's kernel call (its autograd.Function,
               whose backward is the plain form's) at ZeroScope's four levels, bf16 on
               "ring" and fp32 on "simple", against autograd through the plain form
  unet_routing every self- and cross-attention shape of SD-1.5 512px, AudioLDM 5 s,
               ZeroScope 576x320x16 and the SDXL story (768px, 4 frames, batched CFG)
               through the flash kernel and through plain_attention's einsum, with bounds
               (the SDXL rows also with an SDPA call): the rows
               ops.attention.spatial_flash_predicate is set from, and a check that it
               agrees with them; then the story's bank attention at up_0 and up_1
               (attention_with_lse, [2, 4 T] queries over the sampled bank) on the kernel
               and in its plain form
  unet_check   the SD-1.5 UNet routed through the flash kernel, against fp32
  unet3d_check the ZeroScope UNet3D routed through the temporal kernel, against fp32
  video_step_profile  device time by kernel of that UNet3D call (one denoise step)
  paged_check  one decode chunk of the 8B int8 model over a paged pool, through the
               paged decode kernel and through its plain version
  int4_check   one forward of the 8B int4 model (a 128-token prefill and a 16-slot
               decode step), through the int4 kernel and through its plain version
  chat         the 8B int8 Llama (llama3_8b width and depth, random weights from a
               seed) through make_llama_chat_fn: a 128-token prompt, 150 greedy tokens;
               and one measured row: the contiguous decode's mha_reference at B 1,
               1758 keys beside the split paged kernel over an identity page table
  request      SpiderFree.chat text+image requests: the 8B chat backbone, tag
               dispatch, SD-1.5 at 512x512 with 40 DDIM steps and CFG 7.5
  any_to_many  SpiderFree.chat requests that render text, image, audio and video:
               the above plus AudioLDM-l (5 s, 40 steps) and ZeroScope (576x320,
               16 frames, 40 steps); the first is a warm-up, both are printed
  http         the any-to-many request through serving/http_server.py (serve on a
               free port, the resident models): one streamed POST /chat, server-sent
               events in the order text, image, video, audio, done, the seconds to each,
               the PNG, WAV and video frames decoded to their shapes; one POST answered
               in one JSON body, the same answer; launches as any_to_many's
  orchestrator the three decoder stages of that request one after another, then through
               serving/orchestrator.py (StageOrchestrator, run_request_concurrent), each
               stage on its own thread and CUDA stream: serial and concurrent seconds,
               overlap_x, the media bit-equal both ways, launches per route exact
  serving      bench_suite.py::bench_paged_serving through the port: 24 mixed-length
               prompts, 48 new tokens each, after 4 warm-up requests, through the
               contiguous batcher (8 slots, int8), the paged batcher (16 slots over
               32 blocks of 128, int8) and the same paged batcher on the int4 model;
               then device ms a 16-slot paged decode step of the int4 model, profiled
  speculative  bench_suite.py::bench_speculative_decode's point on the 8B int8 model:
               128 prompt ids, 128 new tokens, gamma 8, n-grams up to 3; tok/s of the
               stepped greedy generate, the host loop and the on-device loop (each
               twice, the same bits), the oracle curve (about 100%, 50% and 0%
               acceptance), windows and tokens a window, 32 x (1 + windows) flash
               launches a run; the prefix it shares with the stepped stream and the
               stepped top-2 gap where they part; SpiderFree.chat with the speculative
               chat function beside the plain one
  chat_stream  decode.stream_generate on the 8B: 150 tokens after the 128-token prompt,
               equal to generate's; time to first token, tok/s
  llm_batcher  serving/batcher.py::LlmBatcher: 8 serving prompts at once, 48 tokens;
               each wave's tokens equal to a generate over its padded array; agreement
               with single-request decoding as a share; waves, tok/s
  qwen2        qwen2_7b at full width and depth (random, q/k/v biases nonzero): int8
               prefill T 128 + 32 tokens; the same with mrope positions (equal tokens);
               the paged batcher against fresh greedy decodes; int4 generate with its
               launches by route; a synthetic Qwen2-layout checkpoint (4 of 28 layers)
               through from_pretrained('llama', path=...)
  llama2       llama2_7b int8 at full width and depth: prefill T 128 + 32 tokens
  moe          a Llama at llama3_8b widths cut to 2 layers with 4 experts: top-1 and
               top-2 forwards against plain attention, make_lm_train_step at [4, 512]
               with the aux term, peak GB
  train        the train entry's own build_runner (spider_tpu_torch/train.py: task ->
               datasets -> build_spider_from_config(preset='full') -> runner_base) at
               full width (LoRA r 32 on the llama3_8b architecture with the extended
               vocabulary, bf16 base frozen, remat; ImageBind-huge; the MoE aligner)
               with the resident SD-1.5, ZeroScope and AudioLDM pipelines as alignment
               targets: one epoch of RunnerBase.train_epoch over the t2i_cc_sbu,
               i2t_cc_sbu and t2a_audiocap builders at batch 4 (MultiIterLoader,
               metrics.jsonl), timed train_step calls per task (IMAGE, TEXT with an
               image input, AUDIO; padded and live tokens), 8 steps on one repeated
               batch, one step's loss and LoRA gradients through the backward kernels
               against the plain backward, make_lm_train_step at [4, 512], profiled
               steps of each (device time and wall time of the same steps), then
               RunnerBase.train() (epoch loop, checkpoint) and a checkpoint round trip; its
               Spider holds SAM ViT-H (bf16, frozen), and part mask_step takes three MASK
               steps (1024 px IMAGE_SAM, a binary MASK_GT), the mask decoder's gradients
               through the backward kernels against the plain backward, SAM's encoders
               bit-equal after them
  spider_generate  serve what train trained: SpiderInference from the train config
               (preset 'full') with the resident pipelines, the trainable parameters
               restored bit for bit through load_demo_checkpoint from the checkpoint
               RunnerBase.train() wrote; Spider.generate on a question with an image
               input (ImageBind-huge), task [IMAGE], 64 new tokens, twice (the same
               bits) and once for the prefill alone; then _decode_modality_infer for
               IMAGE, AUDIO and VIDEO from that run's hidden states with each signal
               run written into the token row: fused conditioning, media, launches
  train_data   train_configs/spider_train.py, the production recipe, through the train
               entry's build_runner with preset 'full' and SAM ViT-H, its 21 builders at
               their full-size defaults (224 px, SAM 1024, 128 x 204 mel, 5 clips) on
               real-format sources the port's own writers put in a temporary directory:
               cc_sbu-, webvid- and audiocap-style tar shards (jpg where PIL imports, mp4
               where cv2 writes one, else <ext>.npy; 10 s flac and wav at 16 kHz), a
               REFER corpus (refs(unc).p, instances.json with polygons and compressed
               RLE, jpg images), a travel JSON, an HDF5 story file where h5py imports
               (else the story builders' synthetic twin); batch sizes, ratios,
               length_bucket and max_context_len as the config gives them. One
               RunnerBase.train_step from each builder in the config's order (task,
               padded and live tokens, step and data seconds, finite losses, flash / dq
               / dk-dv launches by route as the config implies, SAM's share in the MASK
               step), peak GB, HbmBudget's report, StepTimer p50/p90, the tar reader of
               each tar builder (the native library built in spider_tpu_torch/build/,
               or the phase fails); a 16-iteration train_epoch through MultiIterLoader
               at the config's ratios; PrefetchLoader(device=cuda:0) bit-equal to
               prepare_sample, and the data seconds a consumer waits with and without
               it; common/profiler.trace around one step, whose device rows name the
               three flash kernels
  story_check  one SDXL story UNet call at 768px (4 frames, id_length 4, batched CFG,
               consistent self-attention on the up blocks) routed through the kernel,
               with plain attention, and in fp32; 176 flash launches, all wgmma
  story_step_profile  device time by kernel of that UNet call (one denoise step)
  story        from_pretrained('sdxl_story') (random, bf16) and story_generation through
               the serving wiring at StoryDiffusion's point: 768px, 4 frames, id_length
               4, sa_ratio 0.5, 50 Euler steps, CFG 5.0: seconds of encoding, denoise
               and VAE, steps/s (and 5 steps batched against split CFG), peak GB,
               frames, 8800 flash launches
  story_http   SpiderFree.chat through the HTTP server, the 8B reply with a fixed
               IMAGESTORY span appended, the story_fn wired in: a story event of 4 PNGs
  story_photomaker  the ref-image mode: PhotoMaker at photomaker_v1 width, two seeded
               224px id images, the same story
  grounding    BOX through the spider_decoder_infer twin's build_default_decoders(tiny=False):
               Grounding DINO (Swin-T + BERT-base, 900 queries, 512 px; bf16, random from a
               seed) on a seeded 480x640 image and a caption: seconds a
               GroundingDINOInference call (median of 3 after a warm-up), boxes, top scores,
               device busy share, 6 flash launches a call, all wgmma
  grounding_check  its raw boxes and scores in bf16 on the kernel and with plain attention,
               each against an fp32 copy with plain attention (the unet_check rule)
  mask         MASK through the same twin behind SpiderDecoderInfer: DINO's top box, rescaled,
               prompts SAM ViT-H (1024 px, bf16); the low-res mask brought to the image's size;
               encoder and decoder seconds, peak GB, flash launches a decode, all wgmma
  mask_check   SAM's box decode in bf16 on the kernel and plain, against fp32
  grounding_profile  device time by kernel of one DINO call and one SAM encode, with the
               share of the deformable attention (ops/msda.py) and of the ViT attention
  omni         Qwen2.5-Omni-7B at full width and depth (the thinker's Qwen2 decoder, its
               audio and vision towers and the talker in bf16, token2wav in fp32; random
               from seed 0) built by from_pretrained('omni_speech') and driven through
               OmniSpeechPipeline.chat_with_speech after a shorter warm-up turn: a text
               prompt, a seeded 448x448 image (256 tokens) and 10 s of 128-bin log-mel
               (250 tokens); 64 thinker tokens, up to 128 codec tokens under HF's default
               sampling from a seeded generator, token2wav with 10 RK4 steps and guidance
               0.5: seconds of each tower's encode, thinker prefill ms and decode tok/s,
               talker tok/s, token2wav seconds, the turn's seconds, peak GB; the waveform
               finite, within [-1, 1] and 2 x codes x 240 samples; 28 flash launches a
               prefill (the thinker's and the talker's), all wgmma
  omni_check   the thinker's prefill logits in bf16 on the kernel and with plain
               attention, each against an fp32 copy with plain attention (streamed a
               layer at a time), the unet_check rule
  omni_profile device time by kernel of the towers' encodes with one thinker prefill, and
               of one DiT call, with the share of the towers' and the DiT's plain attention
  video_sharded  the sharded video denoise and decode (pipelines/vd.py __call__(mesh=)):
               the temporal kernel against its plain version at the shapes one rank of
               a cfg 2 x sp 4 mesh runs (B 1, F 16, every frame of P / 4 pixels: 720,
               180, 45, 12 padded) with bounds, and the bytes that rank would send a
               denoise step (all-to-all, halo, GroupNorm moments, cfg join: computed
               from the configuration, not timed); then over the NCCL world of one
               (a cfg 1 x sp 1 mesh) one CFG UNet3D call through the frame-split code
               and the plain call, each against fp32 (the unet_check rule), and the
               whole ZeroScope call (576x320, 16 frames, 40 steps, CFG 7.5) sharded and
               unsharded on the same latents: seconds, the frames' difference in
               levels, launches by route equal, 34 tattn launches a UNet3D call on
               "ring", and each call's denoised latents against the same 40 steps
               through the fp32 copy (the unet_check rule); and the 40 steps through
               the fp32 copy sharded and unsharded, within VIDEO_SHARDED_FP32_REL
               (relative L2) of each other
  parallel     the training side of the multi-card code on this one card (one H100:
               no cross-card collective can run): init_distributed_mode at a world of
               one (nccl on 127.0.0.1, a free port) and the five-axis DeviceMesh;
               the ring at Llama-3-8B's attention (B 1, T 8192, 32/8 heads, D 128,
               bf16, causal, a ring of 4: the four ranks' block steps in one process,
               ops/ring_attention.ring_attention_ranks), forward and backward, against
               one flash_attention_with_lse call over T 8192 and its backward (out
               2e-2, lse 1e-3, gradients 2e-2 + 2^-7 |ref|) and against the fp32 plain
               form at T 2048; a fully masked block's merge bit-unchanged; the block
               kinds (q_offset +T_local, 0, -T_local) against the plain form; the
               same bits twice; 16 / 16 / 16 launches, all "wgmma"; device ms per
               rank and in total against the single call, SDPA and the bound; then
               ring_attention, moe_ffn_expert_parallel (4096 -> 14336, 4 experts) and
               gpipe (S 1) through the NCCL world of one, each the bits of its
               one-device form; then train_configs/spider_longctx_train.py with
               preset full through the train entry's build_runner: as written (data 2
               x context 4) it raises the ValueError naming the world of one; with
               run.mesh all ones 2 steps through the FSDP2/HSDP wrapping (losses,
               s/step, peak GB), then, the process group destroyed, the unwrapped
               runner's 2 steps on the same batches (losses within 2e-3 relative);
               between them the MoE Llama (llama3_8b widths, 2 layers, 4 experts,
               top-2) through shard_model over the world of one against the same model
               unsharded (a forward at [4, 512], one make_lm_train_step: loss and aux
               within 2e-3 relative, its layers gating through moe_ffn_sharded), and the
               int4 Llama (4 layers) through parallelize_llama at model 1: 16 greedy
               tokens after a 128-token prompt equal to the unwrapped model's
  checkpoint   HF/diffusers checkpoints in their real layouts, synthetic (seeded
               random weights), written at full size to a temporary directory by the
               port's own safetensors writer, their key lists equal to the real
               checkpoints' (tests/fixtures/convert_keys/), then loaded through the
               port's entry points: the Llama-3-8B (full width and depth, bf16, four
               shards and an index) through from_pretrained('llama', path=...), every
               int8 and bf16 tensor equal to the on-card conversion of the written ones,
               and 32 greedy tokens after a T 128 prefill (32 flash_fwd launches, the
               slice's main path) equal to a model filled in memory from the same
               tensors; SD-1.5, ZeroScope and AudioLDM (diffusers subfolders, fp16, the
               vocoder weight-normed in a .bin) and ImageBind-huge (one fp32 .pth)
               through from_pretrained(kind, path=...), every tensor equal, and one CFG
               UNet call of SD-1.5 at 512px bit-equal to the in-memory pipeline's; then
               build_full_spider(paths={'llama': ...}): base leaves bit-equal, the
               vocabulary rows past 128256 the reference's extension rows. Load
               seconds, GB/s, device GB and the peak host RSS (sampled) of each load;
               then the r1_llama3_8B twins on that directory through SPIDER_TPU_LLM_CKPT:
               the infer twin's reply (unquantised, as the reference's serving loader)
               equal to a model filled in memory from the same tensors, and the gradio
               twin's server answering one POST /chat; SAM ViT-H and Grounding DINO as one
               fp32 .pth each, loaded with from_pretrained(kind, path=...); then a
               Qwen2.5-Omni-7B checkpoint (bf16 safetensors, config.json; full width, 4 of
               28 LLM and talker layers and 4 of 32 tower layers) through
               from_pretrained('qwen_omni_thinker' and 'omni_speech', path=...), every
               tensor equal, the thinker's reply equal to one filled in memory, and the
               qwen2_5omni_infer twin through SPIDER_TPU_OMNI_CKPT
Then the run's total seconds, the kernel summary, the card's `nvidia-smi` name
and power limit, and as the last line {"ok": true, "device": {...}}.

Each main-path phase (chat, request, any_to_many, http, orchestrator, each serving
configuration, speculative to moe, story, story_http, story_photomaker, grounding, mask, omni, the
train steps (the MASK step among them), spider_generate, train_data's steps and epoch, the
two video_sharded calls, the parallel phase's ring, MoE, int4 and runner steps, the
checkpoint decodes and the r1 twins) sets every kernel's launch count to 0 just before it runs and
reads the counts just after; the kernel summary's `launches` is their sum. Launches made to compare a kernel with its
plain version are not counted. Every kernel's count is also read per route,
and the run fails if a main-path launch took a general route: every bf16
shape of the main paths belongs to the flash wgmma routes, the temporal ring
form and the paged split form; the int4 launches are held route by route
(stream, wgmma, and the first kernel for down at up to 16 rows).

`python3 chip_smoke.py kernels` stops after the kernel and routing rows (no
models are built); `python3 chip_smoke.py checkpoint` runs the build, the
wgmma probe and the checkpoint phase only; `python3 chip_smoke.py family` the
build, the wgmma probe and the phases speculative to moe; `python3 chip_smoke.py
story` the build, the wgmma probe, tattn_grad, the routing rows and the story
phases (on the 8B int8 model it builds); `python3 chip_smoke.py grounding` the
build, the wgmma probe, the backward rows at SAM's shapes, the routing rows, the
grounding phases, the train phase's mask_step alone (the 8B Spider with SAM,
built through the train entry) and the two grounding checkpoints; `python3
chip_smoke.py omni` the build, the wgmma probe, the flash rows at the Omni prefill
shapes, the omni phases and the Omni checkpoint; `python3 chip_smoke.py data` the
build, the wgmma probe and train_data (with the three pipelines it needs as alignment
targets); `python3 chip_smoke.py parallel` the build, the wgmma probe and the parallel
phase (run in the whole script after train_data and video_sharded, before checkpoint);
`python3 chip_smoke.py video_sharded` the build, the wgmma probe and the video_sharded
phase (on the ZeroScope pipeline it builds). None prints the final line.

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
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SD_CAPTION = "a running horse on a beach"
AUDIO_CAPTION = "galloping hooves on sand"
VIDEO_CAPTION = "a horse running on a beach"
PROMPT_TOKENS = 128
# 128 TinyTokenizer tokens with its BOS.
CHAT_PROMPT = ("Describe a horse running on a beach at sunset. " * 8)[:PROMPT_TOKENS - 1]
NEW_TOKENS = 150
STEPS = 40
GUIDANCE = 7.5
REQUESTS = 2
ANY_TO_MANY_REQUESTS = 2
VIDEO_HW_FRAMES = (320, 576, 16)
AUDIO_SECONDS = 5.0
AUDIO_LATENT_HW = (256, 32)           # AudioLDM's latent for 5 s; main() holds it to the pipe's
# ops.attention.spatial_flash_predicate may send a shape to the side that is slower
# on the device by at most this factor (timing noise near a crossover).
ROUTING_SLACK = 1.25
# "No slower" on launch-bound shapes, where two ~10-40 us device times are
# compared: the new route may read up to this factor of the old one's time.
NO_SLOWER = 1.10
# The temporal kernel's device time at ZeroScope level 0 may be at most this:
# two thirds of the synchronous form's 0.325 ms.
TATTN_L0_MS = 0.217
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
SOURCES = ("flash_fwd", "tattn_fwd", "paged_decode", "int4_matmul", "flash_bwd", "wgmma_probe",
           "group_norm")
# Every kernel has routes, each with its general one, which no bf16 main-path
# launch may take: the flash kernels' mma.sync forms, the temporal and paged
# kernels' first, synchronous forms. The int4 kernel's first form is the rule's
# own choice for down (K/2 = 7168) at up to 16 rows, so its main-path counts
# are held route by route instead (int4_route_counts). The GroupNorm kernel
# has one form, and its wrapper takes every bf16 CUDA norm: a bf16 norm off
# it takes the plain form, which counts nothing, so the checks hold its
# launches to the model's norms instead (phase_unet_check, phase_unet3d_check).
ROUTED = {"flash_fwd": "mma", "flash_bwd_dq": "mma", "flash_bwd_dkv": "mma",
          "tattn_fwd": "simple", "paged_decode": "simple", "int4_matmul": None,
          "group_norm": None}
WRAPPER_CALLS = 1000
SERVING_EARLIER_TOK_S = {"contiguous_bs8_int8": 102.8, "paged_bs16_int8": 141.1,
                         "paged_bs16_int4": 162.6}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "tattn_fwd", "paged_decode",
           "int4_matmul", "group_norm")
# Flash backward kernels vs plain: the kernels round P and dS to bf16 for the
# second products, sum in another order and round the gradients to bf16.
BWD_ATOL = 2e-2
BWD_REL = 2.0 ** -7
# Below this many keys a query (ROADMAP C6) a backward row is held to the
# plain form on fp32 inputs: both routes miss the bf16 plain form alike there.
C6_MIN_KEYS = 40
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): a kernel's
# bound is the larger of bytes / HBM rate and operations / bf16 tensor rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TRAIN_BATCH = 4
TRAIN_BUCKET = 64
TRAIN_EPOCH_ITERS = 6
TRAIN_IMAGE_SIZE = 224                # imagebind_huge's input
TRAIN_MEL_BINS, TRAIN_MEL_FRAMES = 128, 204
TRAIN_LM_SHAPE = (4, 512)
FROZEN_ROWS = 128256
# One train step's LoRA gradients through the backward kernels against the
# same step through the plain backward: both routes round every layer's dq,
# dk, dv to bf16, the kernels also P and dS, and 32 layers of bf16 backward
# carry that noise down; a wrong mask, scale or transposition turns the
# gradient of every layer below it into noise (relative difference ~1.4,
# cosine ~0).
GRAD_REL = 5e-2
GRAD_COS = 0.999
# The checkpoint phase: seed of the synthetic weights, shards of the 8B,
# greedy tokens compared after the loaded model's prefill.
CKPT_SEED = 11
GENERATE_TOKENS = 64                  # Spider.generate's new tokens in spider_generate
CKPT_SHARDS = 4
CKPT_NEW_TOKENS = 32


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


def bound_ms(moved_bytes: float, flops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the dense bf16
    tensor rate, whichever is longer."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                moved_bytes=moved_bytes, flops=flops)


def live_pairs(B, T, S, causal, kv_len=None, q_offset=None) -> int:
    """(query, key) pairs the attention mask leaves live in this call."""
    import torch

    from spider_tpu_torch.ops.attention import _live_and_offset

    live, off = _live_and_offset(B, T, S, kv_len, q_offset, "cpu")
    per_row = live[:, None].expand(B, T).clamp(max=S).long()
    if causal:
        reach = torch.arange(T)[None, :] + off[:, None].long() + 1
        per_row = torch.minimum(per_row, reach.clamp(min=0))
    return int(per_row.sum())


def sdpa_call(q, k, v, kw):
    """(q, k, v heads first, keyword arguments) of the one
    F.scaled_dot_product_attention call that computes the case `kw` on
    q [B,T,Hq,D], k, v [B,S,Hkv,D]: `is_causal` where the live window is a
    prefix all samples share and the queries start at its first key, else a
    boolean mask [B,1,T,S]. With a mask the GQA group is spelt out by
    repeating k and v (returned as the factor to repeat by), since not every
    SDPA backend takes `enable_gqa` beside a mask."""
    from spider_tpu_torch.ops.attention import _mask

    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    causal, kv_len, q_offset = kw["causal"], kw.get("kv_len"), kw.get("q_offset")
    n = S
    if kv_len is not None and len(set(kv_len.tolist())) == 1:
        n, kv_len = int(kv_len[0]), None                    # a shared prefix: slice it
    qs, ks, vs = q.transpose(1, 2), k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
    if kv_len is None and (not causal or (T == n and q_offset in (None, 0))):
        return (qs, ks, vs), dict(is_causal=causal, enable_gqa=Hq != Hkv), 1
    mask = _mask(B, T, S, causal, kw.get("kv_len"), q_offset, q.device)[:, None, :, :n]
    return (qs, ks, vs), dict(attn_mask=mask), Hq // Hkv


def launch_counters():
    from spider_tpu_torch.ops.attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from spider_tpu_torch.ops.group_norm import group_norm
    from spider_tpu_torch.ops.paged_attention import paged_decode_attention
    from spider_tpu_torch.ops.quant import int4_matmul
    from spider_tpu_torch.ops.temporal_attention import temporal_attention

    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "tattn_fwd": temporal_attention,
            "paged_decode": paged_decode_attention, "int4_matmul": int4_matmul,
            "group_norm": group_norm}


def reset_launches() -> None:
    from spider_tpu_torch.ops.launch import reset_launches as reset

    for fn in launch_counters().values():
        reset(fn)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def read_route_launches() -> dict:
    counters = launch_counters()
    return {name: dict(counters[name].route_launches) for name in ROUTED}


def on_ruled_route(routes: dict) -> bool:
    """No main-path launch took a general route."""
    return all(r[ROUTED[name]] == 0 for name, r in routes.items() if ROUTED[name])


def int4_route_counts(cfg, decode_steps: int, prefills: int) -> dict:
    """int4 launches by route that `decode_steps` forwards of up to 16 rows and
    `prefills` forwards of 48 to 1024 rows make: 7 projections a layer and the
    lm_head; of a decode step's, each layer's down (K/2 over 2048) is the
    first kernel's by the rule."""
    L = cfg.num_hidden_layers
    return dict(stream=(6 * L + 1) * decode_steps, mma=L * decode_steps,
                wgmma=(7 * L + 1) * prefills)


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

def unet_attention_shapes(cfg, lat_h: int, lat_w: int):
    """(level name, transformer blocks, T, heads, D) of every level of a UNet2D
    or UNet3D configuration that holds transformer blocks; each block runs one
    self-attention (S = T) and one cross-attention (S = the context length)."""
    n = len(cfg.block_out_channels)
    depth = getattr(cfg, "transformer_layers_per_block", (1,) * n)

    def level(lvl: int):
        H = cfg.num_attention_heads[lvl]
        return (lat_h >> lvl) * (lat_w >> lvl), H, cfg.block_out_channels[lvl] // H

    shapes = []
    for lvl in range(n):
        if cfg.cross_attn_blocks[lvl] and depth[lvl] > 0:
            shapes.append((f"L{lvl}", (2 * cfg.layers_per_block + 1) * depth[lvl], *level(lvl)))
    if (cfg.cross_attn_blocks[-1] or not hasattr(cfg, "transformer_layers_per_block")
            or getattr(cfg, "addition_embed_type", None) == "text_time"):
        # the UNet3D always has one, as the SDXL UNet does
        shapes.append(("mid", max(depth[-1], 1), *level(n - 1)))
    return shapes


def flash_launches_per_unet_call(cfg, lat_h: int, lat_w: int, ctx_len: int,
                                 batch: int) -> int:
    """Flash launches in one UNet2D or UNet3D call (batch = samples x frames):
    each transformer block's self- and cross-attention where
    ops.attention.spatial_flash_predicate holds."""
    from spider_tpu_torch.ops.attention import spatial_flash_predicate

    return sum(blocks * (spatial_flash_predicate(batch, T, T, H, D)
                         + spatial_flash_predicate(batch, T, ctx_len, H, D))
               for _, blocks, T, H, D in unet_attention_shapes(cfg, lat_h, lat_w))


def tattn_launches_per_unet3d_call(cfg, lat_h: int, lat_w: int, frames: int) -> int:
    """Temporal-kernel launches in one UNet3D call: two attentions in each
    TransformerTemporal whose level is inside the kernel's predicate."""
    from spider_tpu_torch.ops.temporal_attention import kernel_predicate

    tt, _ = unet3d_temporal_layers(cfg)
    return sum(2 * n * kernel_predicate(cfg.num_attention_heads[lvl], frames, P,
                                        cfg.block_out_channels[lvl])
               for lvl, (n, P) in enumerate(zip(tt, unet3d_level_pixels(cfg, lat_h, lat_w))))


def unet3d_level_pixels(cfg, lat_h: int, lat_w: int):
    """Pixels of each UNet3D level (a stride-2 conv with padding 1 halves
    each side, rounding up)."""
    out = []
    for _ in cfg.block_out_channels:
        out.append(lat_h * lat_w)
        lat_h, lat_w = (lat_h + 1) // 2, (lat_w + 1) // 2
    return out


def unet3d_temporal_layers(cfg):
    """(TransformerTemporal count, TemporalConv count) of each level of a UNet3D
    configuration, the mid block's on the last level."""
    n, lpb = len(cfg.block_out_channels), cfg.layers_per_block
    tt, tc = [0] * n, [0] * n
    tt[0] += 1                                             # transformer_in
    for lvl in range(n):
        tc[lvl] += 2 * lpb + 1                             # down + up blocks
        if cfg.cross_attn_blocks[lvl]:
            tt[lvl] += 2 * lpb + 1
    tt[-1] += 1                                            # mid_tattn
    tc[-1] += 2                                            # mid_tconv_0, _1
    return tt, tc


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

def phase_kernel_flash(dev, spider_free_T: int, only: str = ""):
    """Rows of the flash forward (see the module docstring); `only` keeps the
    cases whose name starts with it."""
    import torch

    from spider_tpu_torch.ops import attention as A

    def inputs(B, T, S, Hq, Hkv, D, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        mk = lambda *s: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16)
        return mk(B, T, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    B_lm, T_lm = TRAIN_LM_SHAPE
    omni_T, omni_T2 = omni_prefill_lengths()
    cases = [
        # the train path's cache-free causal forward: the LM step and a Spider
        # step of batch 4 padded to two length buckets
        (f"train_B{B_lm}_T{T_lm}", (B_lm, T_lm, T_lm, 32, 8, 128), dict(causal=True)),
        (f"train_B{TRAIN_BATCH}_T{2 * TRAIN_BUCKET}",
         (TRAIN_BATCH, 2 * TRAIN_BUCKET, 2 * TRAIN_BUCKET, 32, 8, 128), dict(causal=True)),
        ("prefill_T128", (1, 128, 128 + NEW_TOKENS, 32, 8, 128),
         dict(causal=True, kv_len=i32(128), q_offset=0)),
        (f"prefill_T{spider_free_T}",
         (1, spider_free_T, spider_free_T + NEW_TOKENS, 32, 8, 128),
         dict(causal=True, kv_len=i32(spider_free_T), q_offset=0)),
        ("unet_self_T4096_D40", (2, 4096, 4096, 8, 8, 40), dict(causal=False)),
        ("unet_cross_T4096_S77_D40", (2, 4096, 77, 8, 8, 40), dict(causal=False)),
        ("ragged_kv_len", (2, 333, 1000, 32, 8, 128),
         dict(causal=False, kv_len=i32(777, 1000))),
        ("zeroscope_self_T2880_D40", (32, 2880, 2880, 8, 8, 40), dict(causal=False)),
        ("audioldm_self_T8192_D16", (2, 8192, 8192, 8, 8, 16), dict(causal=False)),
        ("audioldm_cross_T8192_S1_D16", (2, 8192, 1, 8, 8, 16), dict(causal=False)),
        # a speculative verify window mid-run: 8 queries at q_offset = kv_len
        # over the cache of T + N + G = 264 keys, kv_len + 8 of them live
        ("verify_T8_S264", (1, SPEC_GAMMA, 264, 32, 8, 128),
         dict(causal=True, kv_len=i32(200), q_offset=i32(192))),
        # the Qwen2-7B (28/4 heads, a group of 7) and Llama-2-7B (32/32) prefills
        ("qwen2_prefill_T128", (1, 128, 128 + FAMILY_NEW_TOKENS, 28, 4, 128),
         dict(causal=True, kv_len=i32(128), q_offset=0)),
        ("llama2_prefill_T128", (1, 128, 128 + FAMILY_NEW_TOKENS, 32, 32, 128),
         dict(causal=True, kv_len=i32(128), q_offset=0)),
        # the Qwen2.5-Omni thinker's prefill (text, image and audio tokens)
        # and its talker's (two rows longer), 28/4 heads over their caches
        (f"omni_thinker_prefill_T{omni_T}", (1, omni_T, omni_T + OMNI_THINKER_TOKENS, 28, 4, 128),
         dict(causal=True, kv_len=i32(omni_T), q_offset=0)),
        (f"omni_talker_prefill_T{omni_T2}",
         (1, omni_T2, omni_T2 + OMNI_SPEECH_TOKENS, 28, 4, 128),
         dict(causal=True, kv_len=i32(omni_T2), q_offset=0)),
    ]
    rows = []
    for i, (name, shape, kw) in enumerate(cases):
        if not name.startswith(only):
            continue
        q, k, v = inputs(*shape, seed=100 + i)
        route = A.flash_route(q.dtype, q.shape[-1])
        want, want_lse = A.mha_reference_with_lse(q, k, v, **kw)
        # both routes on the same inputs: the one the rule names, and the
        # general one it replaced here
        by_route = {}
        for r in dict.fromkeys((route, "mma")):
            out, lse = A.flash_attention_with_lse(q, k, v, route=r, **kw)
            torch.cuda.synchronize()
            by_route[r] = dict(
                err=(out.float() - want.float()).abs().max().item(),
                err_lse=(lse - want_lse).abs().max().item(),
                finite=bool(torch.isfinite(out).all() and torch.isfinite(lse).all()))
            del out, lse
        del want, want_lse
        for r, got in by_route.items():
            call = lambda: A.flash_attention_with_lse(q, k, v, route=r, **kw)
            got["ms"], got["device_ms"] = cuda_ms(call), device_ms(call)
        err, err_lse = by_route[route]["err"], by_route[route]["err_lse"]
        finite = all(g["finite"] for g in by_route.values())
        in_bound = all(g["err"] <= OUT_ATOL and g["err_lse"] <= LSE_ATOL
                       for g in by_route.values())
        ms = by_route[route]["ms"]
        plain_ms = cuda_ms(lambda: A.mha_reference_with_lse(q, k, v, **kw))
        B, T, S, Hq, Hkv, D = shape
        pairs = live_pairs(B, T, S, kw["causal"], kw.get("kv_len"), kw.get("q_offset"))
        keys = live_pairs(B, 1, S, False, kw.get("kv_len"))       # keys below kv_len
        # q, out [B,T,Hq,D] and the live rows of k, v in bf16, lse fp32; QK^T and PV
        row = dict(kernel="flash_fwd", name=name, B=B, T=T, S=S, Hq=Hq, Hkv=Hkv, D=D,
                   causal=kw["causal"], route=route, max_abs_err=err,
                   max_abs_err_lse=err_lse, ms=ms, device_ms=by_route[route]["device_ms"],
                   previous_route="mma", previous_ms=by_route["mma"]["ms"],
                   previous_device_ms=by_route["mma"]["device_ms"],
                   max_abs_err_previous=by_route["mma"]["err"],
                   max_abs_err_lse_previous=by_route["mma"]["err_lse"],
                   plain_ms=plain_ms, library_ms=None,
                   **bound_ms(2 * (2 * B * T * Hq * D + 2 * keys * Hkv * D) + 4 * B * Hq * T,
                              4 * Hq * D * pairs),
                   ok=finite and in_bound and route == "wgmma")
        # One PyTorch call for the same function, heads first as SDPA takes
        # them; k and v are repeated over the GQA group beforehand where the
        # case needs a mask.
        (qs, ks, vs), sdpa_kw, repeat = sdpa_call(q, k, v, kw)
        if repeat > 1:
            ks, vs = ks.repeat_interleave(repeat, 1), vs.repeat_interleave(repeat, 1)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
        row["library_ms"] = cuda_ms(sdpa)
        # without either wrapper's host time, which a single call of a short
        # kernel mostly measures
        row["library_device_ms"] = device_ms(sdpa)
        row["speedup_device"] = row["previous_device_ms"] / row["device_ms"]
        row["library_call"] = "sdpa " + ("attn_mask" if "attn_mask" in sdpa_kw else "is_causal"
                                         if sdpa_kw["is_causal"] else "full")
        del qs, ks, vs, sdpa_kw
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_kernel_flash_bwd(dev, prefix: str = ""):
    """The two backward kernels against flash_backward_reference on the
    forward kernel's out and lse: one row per kernel and case, each kernel on
    both routes on the same inputs. `ms` is that kernel alone; `plain_ms` the
    plain version, which computes dq, dk and dv together; `library_ms` the
    backward of F.scaled_dot_product_attention (all three gradients too; with
    a mask where the case has a ragged `kv_len`), null only with a cotangent
    of lse, which SDPA does not return. The dq rows also run the kernel twice
    for the same bits. The last three cases are SAM's mask decoder in the MASK
    train step (head dims 32 and 16, 6 prompt tokens); `prefix` keeps the
    cases whose name starts with it."""
    import torch
    import torch.nn.functional as F

    from spider_tpu_torch.ops import attention as A

    def i32(*x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    B, T = TRAIN_LM_SHAPE
    cases = [
        (f"train_B{B}_T{T}", (B, T, T, 32, 8, 128), dict(causal=True), False),
        (f"train_B{TRAIN_BATCH}_T{2 * TRAIN_BUCKET}",
         (TRAIN_BATCH, 2 * TRAIN_BUCKET, 2 * TRAIN_BUCKET, 32, 8, 128), dict(causal=True),
         False),
        ("long_B1_T2048", (1, 2048, 2048, 32, 8, 128), dict(causal=True), False),
        ("padded_prefill_kv_len", (2, 333, 512, 32, 8, 128),
         dict(causal=True, kv_len=i32(333, 200)), False),
        ("ragged_full_D40", (2, 333, 1000, 8, 8, 40), dict(causal=False), False),
        ("with_g_lse", (2, 256, 256, 32, 8, 128), dict(causal=True), True),
    ]
    # SAM's mask decoder in the MASK train step: its three attention shapes
    cases += [(f"sam_{kind}_B{Bc}_T{Tc}_S{S}_D{D}", (Bc, Tc, S, H, H, D), dict(causal=False),
               False)
              for model, _, kind, _, Bc, Tc, S, H, D in grounding_attention_shapes()
              if model == "sam_vit_h_mask_step"]
    cases = [c for c in cases if c[0].startswith(prefix)]
    rows = []
    for i, (name, shape, kw, with_lse) in enumerate(cases):
        Bc, Tc, S, Hq, Hkv, D = shape
        g = torch.Generator(device=dev).manual_seed(500 + i)
        mk = lambda *s: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16)
        q, k, v, do = mk(Bc, Tc, Hq, D), mk(Bc, S, Hkv, D), mk(Bc, S, Hkv, D), mk(Bc, Tc, Hq, D)
        g_lse = (torch.randn((Bc, Hq, Tc), generator=g, device=dev) if with_lse else None)
        route = A.flash_route(q.dtype, D)
        out, lse = A.flash_attention_with_lse(q, k, v, **kw)
        # ROADMAP C6: with few keys a query, each dk, dv sums thousands of rows
        # and the bf16 plain form's own rounding is as large as the kernel's
        # error; such a row is held to the plain form on the inputs in fp32
        few_keys = S < C6_MIN_KEYS
        want = A.flash_backward_reference(
            *((x.float() for x in (q, k, v, out)) if few_keys else (q, k, v, out)), lse,
            do.float() if few_keys else do, g_lse=g_lse, **kw)

        def against_plain(got):
            """(max abs error, excess over the bound, finite) per gradient."""
            res = []
            for a, b in zip(got, want):
                diff = (a.float() - b.float()).abs()
                res.append((diff.max().item(),
                            (diff - (BWD_ATOL + BWD_REL * b.float().abs())).max().item(),
                            bool(torch.isfinite(a).all())))
            return res

        # both kernels through both routes on the same inputs
        by_route = {r: against_plain(A.flash_backward(q, k, v, out, lse, do, g_lse=g_lse,
                                                      route=r, **kw))
                    for r in dict.fromkeys((route, "mma"))}
        torch.cuda.synchronize()
        del want
        errs = [x[0] for x in by_route[route]]
        excess = [x[1] for x in by_route[route]]
        finite = all(x[2] for res in by_route.values() for x in res)
        excess_previous = [x[1] for x in by_route["mma"]]
        live, off = A._live_and_offset(Bc, Tc, S, kw.get("kv_len"), None, dev)
        delta = A._delta(do, out, g_lse)
        args = (q, k, v, do, lse, delta, live, off, kw["causal"], None)
        dq_ms = cuda_ms(lambda: A.flash_bwd_dq(*args, route=route))
        dq_prev_ms = cuda_ms(lambda: A.flash_bwd_dq(*args, route="mma"))
        dkv_ms = cuda_ms(lambda: A.flash_bwd_dkv(*args, route=route))
        dkv_prev_ms = cuda_ms(lambda: A.flash_bwd_dkv(*args, route="mma"))
        plain_ms = cuda_ms(lambda: A.flash_backward_reference(q, k, v, out, lse, do,
                                                             g_lse=g_lse, **kw), reps=3)
        dq_dev = device_ms(lambda: A.flash_bwd_dq(*args, route=route))
        dq_prev_dev = device_ms(lambda: A.flash_bwd_dq(*args, route="mma"))
        # twice for its bits: one block owns its dq rows
        same_bits = bool(torch.equal(A.flash_bwd_dq(*args, route=route),
                                     A.flash_bwd_dq(*args, route=route)))
        dkv_dev = device_ms(lambda: A.flash_bwd_dkv(*args, route=route))
        dkv_prev_dev = device_ms(lambda: A.flash_bwd_dkv(*args, route="mma"))
        library_ms = library_dev = None
        if not with_lse:                 # SDPA returns no lse to take a cotangent of
            (qs, ks, vs), sdpa_kw, repeat = sdpa_call(q, k, v, kw)
            leaves = [x.detach().requires_grad_(True) for x in (qs, ks, vs)]
            o = F.scaled_dot_product_attention(
                leaves[0], *(x.repeat_interleave(repeat, 1) if repeat > 1 else x
                             for x in leaves[1:]), **sdpa_kw)
            go = do.transpose(1, 2)
            sdpa_bwd = lambda: torch.autograd.grad(o, leaves, go, retain_graph=True)
            library_ms, library_dev = cuda_ms(sdpa_bwd), device_ms(sdpa_bwd)
            del leaves, o, qs, ks, vs, sdpa_kw
        pairs = live_pairs(Bc, Tc, S, kw["causal"], kw.get("kv_len"))
        keys = live_pairs(Bc, 1, S, False, kw.get("kv_len"))
        q_bytes, kv_bytes = 2 * Bc * Tc * Hq * D, 2 * keys * Hkv * D
        rows_bytes = 2 * 4 * Bc * Hq * Tc                           # lse and delta, fp32
        common = dict(name=name, B=Bc, T=Tc, S=S, Hq=Hq, Hkv=Hkv, D=D, causal=kw["causal"],
                      g_lse=with_lse, plain_ms=plain_ms, library_ms=library_ms,
                      library_device_ms=library_dev,
                      held_to="plain form in fp32 (C6)" if few_keys else "plain form")
        # dq: q, dO read and dq written, live k, v read; S, dP and dS K
        rows.append(dict(kernel="flash_bwd_dq", **common, route=route, max_abs_err=errs[0],
                         ms=dq_ms, device_ms=dq_dev, previous_route="mma",
                         previous_ms=dq_prev_ms, previous_device_ms=dq_prev_dev,
                         max_abs_err_previous=by_route["mma"][0][0],
                         speedup_device=dq_prev_dev / dq_dev, same_bits_twice=same_bits,
                         **bound_ms(3 * q_bytes + 2 * kv_bytes + rows_bytes,
                                    6 * Hq * D * pairs),
                         ok=finite and excess[0] <= 0 and excess_previous[0] <= 0
                         and same_bits and route == "wgmma"))
        # dk/dv: q, dO, live k, v read, dk, dv written; S, dP, P^T dO and dS^T Q
        rows.append(dict(kernel="flash_bwd_dkv", **common, route=route,
                         max_abs_err=max(errs[1:]),
                         max_abs_err_dk=errs[1], max_abs_err_dv=errs[2], ms=dkv_ms,
                         device_ms=dkv_dev, previous_route="mma", previous_ms=dkv_prev_ms,
                         previous_device_ms=dkv_prev_dev,
                         max_abs_err_previous=max(x[0] for x in by_route["mma"][1:]),
                         speedup_device=dkv_prev_dev / dkv_dev,
                         pair_device_ms=dq_dev + dkv_dev,
                         pair_over_library_device=((dq_dev + dkv_dev) / library_dev
                                                   if library_dev else None),
                         **bound_ms(2 * q_bytes + 4 * kv_bytes + rows_bytes,
                                    8 * Hq * D * pairs),
                         ok=finite and max(excess[1:]) <= 0 and max(excess_previous[1:]) <= 0
                         and route == "wgmma"))
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def phase_wgmma_probe(dev):
    """Single wgmma products through csrc/hopper.cuh (TMA load, swizzled
    descriptors, the wgmma wrappers) against torch.matmul in fp32: fp32
    accumulation of bf16 products differs by summation order only."""
    import ctypes

    import torch

    from spider_tpu_torch.ops import cuda_build

    lib = cuda_build.load("wgmma_probe")
    lib.spider_wgmma_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.spider_wgmma_probe.restype = ctypes.c_int
    g = torch.Generator(device=dev).manual_seed(600)
    mk = lambda *s: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16)
    errs = {}
    for mode, name, a, b in ((0, "ss_k_major_64x128x128", mk(64, 128), mk(128, 128)),
                             (1, "rs_mn_major_64x128x64", mk(64, 64), mk(64, 128))):
        d = torch.full((64, 128), float("nan"), device=dev)
        rc = lib.spider_wgmma_probe(mode, a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        want = a.float() @ (b.float().T if mode == 0 else b.float())
        errs[name] = float("inf") if rc else (d - want).abs().max().item()
    # the dq kernel's second product: dS from registers times a K tile of 128
    # keys read as it lies, at n = D rounded up to 16
    lib.spider_wgmma_probe_dsk.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.spider_wgmma_probe_dsk.restype = ctypes.c_int
    for D in (16, 40, 80, 128):
        a, b = mk(64, 128), mk(128, D)
        d = torch.full((64, D), float("nan"), device=dev)
        rc = lib.spider_wgmma_probe_dsk(a.data_ptr(), b.data_ptr(), d.data_ptr(), D,
                                        torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        errs[f"rs_ds_k_64x{D}x128"] = (float("inf") if rc
                                       else (d - a.float() @ b.float()).abs().max().item())
    return dict(phase="wgmma_probe", max_abs_err=errs, atol=1e-3,
                ok=all(e <= 1e-3 for e in errs.values()))


# The routing rows scale q so that each row's logits have this standard
# deviation (keys and values N(0, 1), D <= 128): the softmax is peaked and a
# typical |out| is 0.5-0.7 at every key count here, where with unscaled q it
# falls as 1/sqrt(keys), to about 0.02 over 4608 keys, under OUT_ATOL itself.
ROUTING_LOGIT_STD = 8.0


def routing_qkv(dev, seed: int, B: int, T: int, S: int, C: int):
    """bf16 q [B, T, C], k and v [B, S, C] for the routing rows: k, v N(0, 1),
    q N(0, 1) times ROUTING_LOGIT_STD, so the scaled logits q.k / sqrt(D)
    have that standard deviation."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda L: torch.randn((B, L, C), generator=g, device=dev, dtype=torch.bfloat16)
    q, k, v = mk(T), mk(S), mk(S)
    return q * ROUTING_LOGIT_STD, k, v


def routing_excess(got, want) -> float:
    """How far a bf16 attention output passes OUT_ATOL + BF16_EPS * |want|
    against the fp32 plain form (<= 0 holds): OUT_ATOL for the kernel's bf16
    probabilities, BF16_EPS * |want| for rounding an output of size |want|
    to bf16."""
    diff = (got.float() - want).abs()
    return (diff - (OUT_ATOL + BF16_EPS * want.abs())).max().item()


def phase_unet_routing(dev):
    """Every self- and cross-attention shape of the four UNets at the sizes
    the main path runs them (CFG batch 2; ZeroScope's 16 frames fold into the
    batch; the SDXL story's 4 frames and batched CFG make a batch of 8),
    through the flash kernel and through plain_attention's einsum, both timed on
    the device (calls queued behind a sleeping kernel) and as single calls,
    each with its bound; the SDXL rows also with one SDPA call's device time.
    Inputs as routing_qkv makes them; the kernel's output is held to the
    fp32 plain form by routing_excess, the bf16 plain form is only timed.
    ops.attention.spatial_flash_predicate is set from these rows; the row fails if
    the rule sends a shape to the slower side by more than ROUTING_SLACK, or
    to a kernel that does not take it. Then the same rows for the attention
    shapes of Grounding DINO's decoder and SAM's mask decoder
    (grounding_attention_shapes), with an SDPA call each."""
    from spider_tpu_torch.models.unet2d import unet_audioldm, unet_sd15, unet_sdxl
    from spider_tpu_torch.models.unet3d import UNet3DConfig

    h, w, frames = VIDEO_HW_FRAMES
    models = [("sd15_512px", unet_sd15(), 64, 64, 77, 2),
              ("audioldm_5s", unet_audioldm(), *AUDIO_LATENT_HW, 1, 2),
              ("zeroscope_576x320x16", UNet3DConfig(), h // 8, w // 8, 77, 2 * frames),
              ("sdxl_story_768px", unet_sdxl(), STORY_HW // 8, STORY_HW // 8, 77,
               2 * len(STORY_PROMPTS))]
    rows = []
    for model, cfg, lat_h, lat_w, ctx_len, B in models:
        for level, blocks, T, H, D in unet_attention_shapes(cfg, lat_h, lat_w):
            for kind, S in (("self", T), ("cross", ctx_len)):
                rows.append(routing_row(dev, 700 + len(rows), model, level, kind, blocks,
                                        B, T, S, H, D, sdpa=model.startswith("sdxl")))
    # Grounding DINO's decoder and SAM's mask decoder call the same helper
    for model, level, kind, calls, B, T, S, H, D in grounding_attention_shapes():
        rows.append(routing_row(dev, 700 + len(rows), model, level, kind, calls, B, T, S, H,
                                D, sdpa=True))
    return rows


def routing_row(dev, seed: int, model: str, level: str, kind: str, blocks: int, B: int,
                T: int, S: int, H: int, D: int, sdpa: bool) -> dict:
    """One unet_routing row: the shape through the flash kernel and through
    plain_attention's einsum (and, with `sdpa`, one SDPA call), device times and
    the bound, the kernel held to the fp32 plain form by routing_excess."""
    import torch

    from spider_tpu_torch.ops import attention as A
    from spider_tpu_torch.ops.attention import (attention, spatial_flash_config,
                                                spatial_flash_predicate)

    q, k, v = routing_qkv(dev, seed, B, T, S, H * D)
    with spatial_flash_config("einsum"):
        plain = lambda: attention(q, k, v, H)
        einsum_ms, einsum_dev = cuda_ms(plain), device_ms(plain)
        want = attention(q.float(), k.float(), v.float(), H)
    flash_ms = flash_dev = err = excess = None
    if D <= A.MAX_HEAD_DIM:
        flash = lambda: A.flash_attention(
            q.reshape(B, T, H, D), k.reshape(B, S, H, D), v.reshape(B, S, H, D),
            causal=False).reshape(B, T, H * D)
        got = flash()
        err = (got.float() - want).abs().max().item()
        excess = routing_excess(got, want)
        del got
        flash_ms, flash_dev = cuda_ms(flash), device_ms(flash)
    extra = bound_ms(2 * (2 * B * T + 2 * B * S) * H * D, 4 * B * H * T * S * D)
    if sdpa:
        qs, ks, vs = (x.reshape(B, -1, H, D).transpose(1, 2) for x in (q, k, v))
        extra["sdpa_device_ms"] = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs))
        del qs, ks, vs
    routed = bool(spatial_flash_predicate(B, T, S, H, D))
    if flash_dev is None:
        ok = not routed
    elif routed:
        ok = excess <= 0 and flash_dev <= ROUTING_SLACK * einsum_dev
    else:
        ok = einsum_dev <= ROUTING_SLACK * flash_dev
    row = dict(phase="unet_routing", model=model, level=level, kind=kind,
               blocks_per_unet_call=blocks, B=B, T=T, S=S, heads=H, D=D,
               flash_device_ms=flash_dev, einsum_device_ms=einsum_dev,
               flash_ms=flash_ms, einsum_ms=einsum_ms, max_abs_err=err,
               mean_abs_out=want.abs().mean().item(), tolerance_excess=excess,
               predicate_routes_to_flash=routed, **extra, ok=ok)
    del q, k, v, want
    torch.cuda.empty_cache()
    return row


# (name, B, F, P, C, H, layout): ZeroScope's four levels (CFG batch 2, 16
# frames, 8 heads), one pixel-major case and a P that is not a multiple of any
# pixel tile the kernel picks.
TATTN_CASES = [("zeroscope_L0_D40", 2, 16, 2880, 320, 8, "bfpc"),
               ("zeroscope_L1_D80", 2, 16, 720, 640, 8, "bfpc"),
               ("zeroscope_L2_D160", 2, 16, 180, 1280, 8, "bfpc"),
               ("zeroscope_mid_D160", 2, 16, 45, 1280, 8, "bfpc"),
               ("bpfc_L1_D80", 2, 16, 720, 640, 8, "bpfc"),
               ("ragged_P1001_D80", 2, 16, 1001, 640, 8, "bfpc")]


def phase_kernel_tattn(dev, cases=TATTN_CASES):
    """The temporal kernel against its plain version, both routes of
    ops/temporal_attention.py::tattn_route on the same inputs: `ms` /
    `device_ms` are the route the rule names ("ring"), `previous_*` the first,
    synchronous form ("simple")."""
    import torch

    from spider_tpu_torch.ops import temporal_attention as TA

    rows = []
    for i, (name, B, F, P, C, H, layout) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        shape = (B, P, F, C) if layout == "bpfc" else (B, F, P, C)
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        route = TA.tattn_route(q.dtype)
        want = TA.temporal_attention_reference(q, k, v, H, layout=layout)
        by_route = {}
        for r in dict.fromkeys((route, "simple")):
            call = lambda: TA.temporal_attention_kernel(q, k, v, H, layout=layout, route=r)
            out = call()
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            by_route[r] = dict(
                err=diff.max().item(),
                excess=(diff - (OUT_ATOL + BF16_EPS * want.float().abs())).max().item(),
                finite=bool(torch.isfinite(out).all()), ms=cuda_ms(call),
                device_ms=device_ms(call))
            del out, diff
        mine, previous = by_route[route], by_route["simple"]
        plain_ms = cuda_ms(lambda: TA.temporal_attention_reference(q, k, v, H, layout=layout))
        moved = 4 * q.numel() * q.element_size()          # q, k, v read; out written
        # One PyTorch call for the same function: frames as the sequence,
        # (batch, pixel, head) as SDPA's batch dimensions.
        if layout == "bpfc":
            qs, ks, vs = (x.reshape(B, P, F, H, C // H).permute(0, 1, 3, 2, 4)
                          for x in (q, k, v))
        else:
            qs, ks, vs = (x.reshape(B, F, P, H, C // H).permute(0, 2, 3, 1, 4)
                          for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        library_ms, library_dev = cuda_ms(sdpa), device_ms(sdpa)
        del qs, ks, vs
        bound = bound_ms(moved, 4 * B * P * H * F * F * (C // H))
        rows.append(dict(kernel="tattn_fwd", name=name, B=B, F=F, P=P, C=C, H=H, D=C // H,
                         layout=layout, route=route, max_abs_err=mine["err"],
                         excess_over_bound=mine["excess"],
                         max_abs_plain=want.float().abs().max().item(), ms=mine["ms"],
                         device_ms=mine["device_ms"], previous_route="simple",
                         previous_ms=previous["ms"], previous_device_ms=previous["device_ms"],
                         max_abs_err_previous=previous["err"],
                         speedup_device=previous["device_ms"] / mine["device_ms"],
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_device_ms=library_dev, **bound,
                         share_of_bound=bound["bound_ms"] / mine["device_ms"],
                         gb_per_s=moved / (mine["device_ms"] * 1e-3) / 1e9,
                         plain_gb_per_s=moved / (plain_ms * 1e-3) / 1e9,
                         ok=all(g["finite"] and g["excess"] <= 0 for g in by_route.values())
                         and route == "ring"))
        del q, k, v, want
    return rows


# (name, shape) of the GroupNorm rows, both with the fused SiLU: ZeroScope's
# per-video norm at level 0 (64 rows of 0.46 M elements) and its per-frame
# norm at the 5 x 9 level (1,024 rows of 1,800).
GROUP_NORM_CASES = [("zeroscope_video_L0", (2, 320, 16, 2880)),
                    ("zeroscope_frame_5x9", (32, 1280, 5, 9))]


def phase_kernel_group_norm(dev, cases=GROUP_NORM_CASES):
    """The GroupNorm kernel (ops/group_norm.py, "split") with SiLU against
    fp32 F.group_norm + F.silu. Its bound: x read once and y written once at
    the HBM rate (`two_pass_bound_ms`: x read twice, what two passes over a
    tensor beyond L2 move). The plain version and the library yardstick are
    the same call here, bf16 F.group_norm then F.silu: three passes."""
    import torch
    import torch.nn.functional as F

    from spider_tpu_torch.ops import group_norm as GN

    rows = []
    for i, (name, shape) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        C = shape[1]
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
        w = (1 + 0.3 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
        b = (0.3 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
        call = lambda: GN.group_norm_kernel(x, 32, w, b, 1e-5, silu=True)
        out = call()
        torch.cuda.synchronize()
        want = F.silu(F.group_norm(x.float(), 32, w.float(), b.float(), 1e-5))
        diff = (out.float() - want).abs()
        err, excess = diff.max().item(), (diff - (1e-4 + BF16_EPS * want.abs())).max().item()
        same = _same_bits(call, out)
        del out, diff, want
        library = lambda: F.silu(F.group_norm(x, 32, w, b, 1e-5))
        moved = 2 * x.numel() * x.element_size()              # x read, y written
        bound = bound_ms(moved, 0.0)
        ms, dev_ms = cuda_ms(call), device_ms(call)
        rows.append(dict(kernel="group_norm", name=name, shape=list(shape), G=32, silu=True,
                         route="split", max_abs_err=err, excess_over_bound=excess,
                         same_bits=same, ms=ms, device_ms=dev_ms, plain_ms=None,
                         library_ms=cuda_ms(library), library_device_ms=device_ms(library),
                         library_call="F.group_norm + F.silu (bf16)", **bound,
                         two_pass_bound_ms=1.5 * bound["bound_ms"],
                         share_of_bound=bound["bound_ms"] / dev_ms,
                         gb_per_s=moved / (dev_ms * 1e-3) / 1e9,
                         ok=excess <= 0 and same))
        del x
    return rows


def _same_bits(call, first) -> bool:
    """A second run of `call` gives the bits of `first`."""
    import torch

    again = call()
    torch.cuda.synchronize()
    return bool(torch.equal(first, again))


def phase_kernel_paged(dev):
    """The paged decode kernel against its plain version, both routes of
    ops/paged_attention.py::paged_route on the same inputs: `ms` / `device_ms`
    are the route the rule names ("split"), `previous_*` the first form
    ("simple")."""
    import torch

    from spider_tpu_torch.ops import paged_attention as PA

    page, D = 128, 128
    # (name, slots, max_pages, kv_len per slot, query heads, KV heads): the
    # serving shape (16 slots, max_len 512) with lengths at page edges and one
    # past the table; the same with every slot full; the chat's long context
    # in one slot; the serving shape for Qwen2-7B (a group of 7 query heads,
    # padded to the kernel's 16 rows).
    serving_lens = [1, 127, 128, 129, 512, 4 * page + 5, 300, 2, 255, 256, 257, 384, 511,
                    64, 65, 400]
    cases = [("serving_B16_MP4", 16, 4, serving_lens, 32, 8),
             ("serving_B16_MP4_len512", 16, 4, [512] * 16, 32, 8),
             ("chat_B1_MP14_len1758", 1, 14, [1758], 32, 8),
             ("qwen2_B16_MP4", 16, 4, serving_lens, 28, 4)]
    rows = []
    for i, (name, B, MP, lens, Hq, Hkv) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        n_blocks = B * MP + 1
        q = torch.randn((B, Hq, D), generator=g, device=dev, dtype=torch.bfloat16)
        pk, pv = (torch.randn((n_blocks, page, Hkv, D), generator=g, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        table = (1 + torch.randperm(B * MP, generator=g, device=dev)).reshape(B, MP).int()
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, pk, pv, table, kv_len)
        route = PA.paged_route(q.dtype, page, D)
        want = PA.paged_decode_reference(*args)
        by_route = {}
        for r in dict.fromkeys((route, "simple")):
            call = lambda: PA.paged_decode_kernel(*args, route=r)
            out = call()
            torch.cuda.synchronize()
            by_route[r] = dict(err=(out.float() - want.float()).abs().max().item(),
                               finite=bool(torch.isfinite(out).all()),
                               same_bits=_same_bits(call, out), ms=cuda_ms(call),
                               device_ms=device_ms(call))
            del out
        mine, previous = by_route[route], by_route["simple"]
        plain_ms = cuda_ms(lambda: PA.paged_decode_reference(*args))
        plain_dev_ms = device_ms(lambda: PA.paged_decode_reference(*args))
        live = sum(min(n, MP * page) for n in lens)
        moved = 2 * live * Hkv * D * 2                     # live K and V bytes read
        # live K and V, q and out, the table and lengths
        bound = bound_ms(moved + 2 * B * Hq * D * 2 + 4 * B * (MP + 1), 4 * Hq * D * live)
        rows.append(dict(kernel="paged_decode", name=name, B=B, Hq=Hq, Hkv=Hkv, D=D, page=page,
                         max_pages=MP, kv_len=lens, route=route,
                         split_plan=PA.split_plan(MP, page, B, Hkv, torch.cuda
                                                  .get_device_properties(dev)
                                                  .multi_processor_count, Hq // Hkv),
                         max_abs_err=mine["err"], ms=mine["ms"], device_ms=mine["device_ms"],
                         same_bits=mine["same_bits"], previous_route="simple",
                         previous_ms=previous["ms"], previous_device_ms=previous["device_ms"],
                         max_abs_err_previous=previous["err"],
                         speedup_device=previous["device_ms"] / mine["device_ms"],
                         plain_ms=plain_ms,
                         library_ms=None,      # no one PyTorch call walks a page table
                         **bound, share_of_bound=bound["bound_ms"] / mine["device_ms"],
                         plain_device_ms=plain_dev_ms,
                         gb_per_s=moved / (mine["device_ms"] * 1e-3) / 1e9,
                         plain_gb_per_s=moved / (plain_dev_ms * 1e-3) / 1e9,
                         ok=all(g["finite"] and g["err"] <= OUT_ATOL for g in by_route.values())
                         and mine["same_bits"] and route == "split"))
        del q, pk, pv, want
    return rows


def _int4_case(dev, seed, M, K, N):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    packed = torch.randint(-128, 128, (N, K // 2), generator=g, device=dev, dtype=torch.int8)
    scale = torch.full((N,), 1.0 / (4.61 * K ** 0.5), device=dev)
    return x, packed, scale


# llama3_8b's projections (K in, N out); gate and up share a shape.
INT4_SHAPES = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
               "down": (14336, 4096), "lm_head": (4096, 128256)}
# qwen2_7b's: down's K/2 = 9472 keeps it on "mma" at up to 16 rows.
QWEN2_INT4_SHAPES = {"q_o": (3584, 3584), "k_v": (3584, 512), "gate_up": (3584, 18944),
                     "down": (18944, 3584)}


def phase_kernel_int4(dev):
    """The int4 matmul kernel against its plain version, both routes of
    ops/quant.py::int4_route on the same inputs: `ms` / `device_ms` are the
    route the rule names ("stream" at 1 and 16 rows where K/2 <= 2048, "wgmma"
    at 128 and more), `previous_*` the first form ("mma")."""
    import torch

    from spider_tpu_torch.ops import quant as Q

    cases = [(f"{n}_M{M}", M, K, N) for M in (1, 16) for n, (K, N) in INT4_SHAPES.items()]
    cases += [(f"{n}_M{M}", M, *INT4_SHAPES[n]) for M in (128, 256)
              for n in ("q_o", "k_v", "gate_up", "down")]
    cases.append(("lm_head_M128", 128, *INT4_SHAPES["lm_head"]))
    cases += [(f"{n}_M1024", 1024, *INT4_SHAPES[n]) for n in ("gate_up", "down")]
    cases.append(("ragged_M37_K4100_N1000", 37, 4100, 1000))
    cases += [(f"qwen2_{n}_M{M}", M, K, N) for M in (1, 16, 128)
              for n, (K, N) in QWEN2_INT4_SHAPES.items()]
    rows = []
    for i, (name, M, K, N) in enumerate(cases):
        x, packed, scale = _int4_case(dev, 400 + i, M, K, N)
        route = Q.int4_route(x.dtype, M, K // 2, True)
        want = Q.int4_matmul_reference(x, packed, scale, torch.bfloat16)
        by_route = {}
        for r in dict.fromkeys((route, "mma")):
            call = lambda: Q.int4_matmul_kernel(x, packed, scale, torch.bfloat16, route=r)
            out = call()
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            by_route[r] = dict(err=diff.max().item(),
                               excess=(diff - (1e-3 + INT4_REL * want.float().abs())).max().item(),
                               finite=bool(torch.isfinite(out).all()),
                               same_bits=_same_bits(call, out), ms=cuda_ms(call),
                               device_ms=device_ms(call))
            del out, diff
        mine, previous = by_route[route], by_route["mma"]
        plain = lambda: Q.int4_matmul_reference(x, packed, scale, torch.bfloat16)
        plain_ms, plain_dev_ms = cuda_ms(plain), device_ms(plain, calls=5)
        del want
        moved = N * K // 2 + 2 * M * K + 2 * M * N     # packed weight, x, out
        bound = bound_ms(moved + 4 * N, 2 * M * K * N)
        rows.append(dict(kernel="int4_matmul", name=name, M=M, K=K, N=N, route=route,
                         max_abs_err=mine["err"], excess_over_bound=mine["excess"],
                         ms=mine["ms"], device_ms=mine["device_ms"],
                         same_bits=mine["same_bits"], previous_route="mma",
                         previous_ms=previous["ms"], previous_device_ms=previous["device_ms"],
                         max_abs_err_previous=previous["err"],
                         speedup_device=previous["device_ms"] / mine["device_ms"],
                         plain_ms=plain_ms,
                         library_ms=None,      # no PyTorch call takes packed int4 weights
                         **bound, share_of_bound=bound["bound_ms"] / mine["device_ms"],
                         plain_device_ms=plain_dev_ms,
                         gb_per_s=moved / (mine["device_ms"] * 1e-3) / 1e9,
                         tflop_per_s=2 * M * K * N / (mine["device_ms"] * 1e-3) / 1e12,
                         ok=all(g["finite"] and g["excess"] <= 0 for g in by_route.values())
                         and mine["same_bits"]
                         and route == ("mma" if K % 32 or (M <= 16 and K > 4096)
                                       else "stream" if M <= 16 else "wgmma")))
        del x, packed, scale
        torch.cuda.empty_cache()
    return rows


def phase_int4_crossover(dev) -> dict:
    """The first kernel and the wgmma form side by side between the stream
    form's 16 rows and the prefill buckets: the rows ops/quant.py::WGMMA_MIN_M
    is read from. The wgmma form is named below the rule's start, so the
    rule's constant is lowered while these rows run."""
    from spider_tpu_torch.ops import quant as Q

    rows = []
    ruled_min = Q.WGMMA_MIN_M
    Q.WGMMA_MIN_M = Q.STREAM_MAX_M + 1
    try:
        for n in ("gate_up", "q_o"):
            for M in (17, 32, 48, 64):
                x, packed, scale = _int4_case(dev, 450 + M, M, *INT4_SHAPES[n])
                ms = {r: device_ms(lambda: Q.int4_matmul_kernel(x, packed, scale, route=r))
                      for r in ("mma", "wgmma")}
                rows.append(dict(shape=n, M=M, mma_device_ms=ms["mma"],
                                 wgmma_device_ms=ms["wgmma"],
                                 ruled="wgmma" if M >= ruled_min else "mma"))
    finally:
        Q.WGMMA_MIN_M = ruled_min
    # The rule may send a row to the side that is slower by at most
    # ROUTING_SLACK on the widest projection, which holds most of the bytes.
    ok = all(r[f"{r['ruled']}_device_ms"]
             <= ROUTING_SLACK * min(r["mma_device_ms"], r["wgmma_device_ms"])
             for r in rows if r["shape"] == "gate_up")
    return dict(phase="int4_crossover", wgmma_min_m=ruled_min, rows=rows, ok=ok)


def wrapper_host_us(call, calls: int = WRAPPER_CALLS) -> float:
    """Host microseconds a call: `calls` calls queued one behind the other,
    no synchronise inside. The shapes are small, so the card keeps up and the
    queue never fills: the time is the wrapper's own."""
    import torch

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def phase_wrapper_us(dev) -> dict:
    """Host cost of the two serving wrappers, at small shapes of the routes
    the main path takes (the host work does not depend on the sizes)."""
    import torch

    from spider_tpu_torch.ops import paged_attention as PA
    from spider_tpu_torch.ops import quant as Q

    x, packed, scale = _int4_case(dev, 470, 16, 512, 64)
    x128 = _int4_case(dev, 471, 128, 512, 64)[0]
    g = torch.Generator(device=dev).manual_seed(472)
    q = torch.randn((2, 8, 64), generator=g, device=dev, dtype=torch.bfloat16)
    pk, pv = (torch.randn((9, 16, 2, 64), generator=g, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    table = torch.arange(1, 9, device=dev, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([5, 60], dtype=torch.int32, device=dev)
    us = dict(
        int4_stream=wrapper_host_us(lambda: Q.int4_matmul_kernel(x, packed, scale)),
        int4_wgmma=wrapper_host_us(lambda: Q.int4_matmul_kernel(x128, packed, scale)),
        paged_split=wrapper_host_us(lambda: PA.paged_decode_kernel(q, pk, pv, table, lens)))
    return dict(phase="wrapper_us", calls=WRAPPER_CALLS, **us,
                ok=all(v > 0 for v in us.values()))


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
        before_routes = dict(paged_decode_attention.route_launches)
        routed = chunk()
        torch.cuda.synchronize()
        launches = paged_decode_attention.launches - before
        routes = {r: c - before_routes[r]
                  for r, c in paged_decode_attention.route_launches.items()}
        with paged_decode_config("plain"):
            plain = chunk()
    diff, agree, scale = _logit_agreement(routed, plain)
    want = cfg.num_hidden_layers * steps
    ok = (bool(torch.isfinite(routed).all()) and launches == want and diff <= LOGIT_ATOL
          and agree >= AGREE_MIN and routes == dict(split=want, simple=0))
    del pool, routed, plain
    torch.cuda.empty_cache()
    return dict(phase="paged_check", model="llama3_8b int8", slots=S, steps=steps,
                logits_max_abs_diff=diff, logits_max_abs=scale, argmax_agree_share=agree,
                paged_launches=launches, paged_launches_expected=want, route_launches=routes,
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
        before_routes = dict(int4_matmul.route_launches)
        routed = forward()
        torch.cuda.synchronize()
        launches = int4_matmul.launches - before
        routes = {r: c - before_routes[r] for r, c in int4_matmul.route_launches.items()}
        with int4_matmul_config("plain"):
            plain = forward()
    rows = {}
    per_forward = 7 * cfg.num_hidden_layers + 1
    # the prefill's 128 rows on "wgmma", the decode step's 16 on "stream" (down: "mma")
    ok = launches == 2 * per_forward and routes == int4_route_counts(cfg, 1, 1)
    for name, r, p in zip(("prefill_T128", "decode_S16"), routed, plain):
        diff, agree, scale = _logit_agreement(r, p)
        rows[name] = dict(logits_max_abs_diff=diff, logits_max_abs=scale,
                          argmax_agree_share=agree)
        ok &= bool(torch.isfinite(r).all()) and diff <= LOGIT_ATOL and agree >= AGREE_MIN
    del cache, routed, plain
    torch.cuda.empty_cache()
    return dict(phase="int4_check", model="llama3_8b int4", **rows, int4_launches=launches,
                route_launches=routes,
                int4_launches_expected=2 * (7 * cfg.num_hidden_layers + 1),
                bounds=dict(logits_atol=LOGIT_ATOL, agree_min=AGREE_MIN), ok=ok)

def _rel_errors(routed, plain, ref):
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    return rel(routed), rel(plain)


def phase_unet_check(pipe, dev):
    """One full-size CFG UNet call in bf16 routed as the main path routes it
    (the kernel where ops.attention.spatial_flash_predicate holds, every GroupNorm
    on its kernel), and the same call with plain bf16 attention and plain
    GroupNorms everywhere, each against an fp32 copy of the UNet (plain
    attention, plain GroupNorms): the kernels inside the real model at its
    real shapes must be no less accurate than the plain path they replace."""
    import dataclasses

    import torch

    from spider_tpu_torch.models.unet2d import UNet2DConditionModel
    from spider_tpu_torch.ops.attention import spatial_flash_config
    from spider_tpu_torch.ops.group_norm import group_norm, group_norm_config

    g = torch.Generator(device=dev).manual_seed(7)
    lat = torch.randn((2, 64, 64, 4), generator=g, device=dev)
    ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([SD_CAPTION])])
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ref_unet = UNet2DConditionModel(
        dataclasses.replace(pipe.unet.config, dtype=torch.float32), dev).eval()
    ref_unet.load_state_dict(pipe.unet.state_dict())
    norms = count_group_norms(pipe.unet)
    with torch.inference_mode():
        before = group_norm.launches
        routed = pipe.unet(lat, t, ctx).float()
        norm_launches = group_norm.launches - before
        with spatial_flash_config("einsum"), group_norm_config("plain"):
            plain = pipe.unet(lat, t, ctx).float()
            ref = ref_unet(lat, t, ctx.float())
        off_kernel = group_norm.launches - before - norm_launches
    del ref_unet
    err_kernel, err_plain = _rel_errors(routed, plain, ref)
    return dict(phase="unet_check", rel_err_kernel_vs_fp32=err_kernel,
                rel_err_plain_vs_fp32=err_plain, group_norm_launches=norm_launches,
                group_norm_launches_expected=norms, group_norm_launches_plain=off_kernel,
                ok=bool(torch.isfinite(routed).all()) and norm_launches == norms > 0
                and off_kernel == 0 and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)


def count_group_norms(model) -> int:
    """The GroupNorms of `model`: a UNet or VAE call runs each once."""
    from torch import nn

    return sum(isinstance(m, nn.GroupNorm) for m in model.modules())


def phase_unet3d_check(pipe, dev):
    """The same check for the ZeroScope UNet3D at full size (CFG batch 2,
    16 frames, 576x320): temporal attention through its kernel at all four
    levels, spatial attention through the flash kernel where
    ops.attention.spatial_flash_predicate holds and every GroupNorm through its
    kernel, then all three plain, each against an fp32 copy with plain
    attention and plain GroupNorms. Every temporal layer of the routed call
    takes a channels-last input and reads the spatial layers' storage in
    place: each of ``_video_view``'s results shares its input's storage."""
    import dataclasses

    import torch

    from spider_tpu_torch.models import unet3d
    from spider_tpu_torch.models.unet3d import (TemporalConv, TransformerTemporal,
                                                UNet3DConditionModel)
    from spider_tpu_torch.ops.attention import flash_attention, spatial_flash_config
    from spider_tpu_torch.ops.group_norm import group_norm, group_norm_config
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
    norms = count_group_norms(pipe.unet)
    temporal = [m for m in pipe.unet.modules()
                if isinstance(m, (TemporalConv, TransformerTemporal))]
    inputs_cl, in_place, video_view = [], [], unet3d._video_view

    def view(x, frames):
        out = video_view(x, frames)
        in_place.append(out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr())
        return out

    hooks = [m.register_forward_pre_hook(lambda m, a: inputs_cl.append(
        a[0].is_contiguous(memory_format=torch.channels_last))) for m in temporal]
    unet3d._video_view = view
    with torch.inference_mode():
        before = temporal_attention.launches, flash_attention.launches, group_norm.launches
        try:
            routed = pipe.unet(lat, t, ctx).float()
        finally:
            unet3d._video_view = video_view
            for hook in hooks:
                hook.remove()
        launches = temporal_attention.launches - before[0]
        flash_launches = flash_attention.launches - before[1]
        norm_launches = group_norm.launches - before[2]
        with temporal_attention_config("plain"), spatial_flash_config("einsum"), \
                group_norm_config("plain"):
            plain = pipe.unet(lat, t, ctx).float()
            ref = ref_unet(lat, t, ctx.float())
        off_kernel = group_norm.launches - before[2] - norm_launches
    del ref_unet
    torch.cuda.empty_cache()
    err_kernel, err_plain = _rel_errors(routed, plain, ref)
    want = tattn_launches_per_unet3d_call(pipe.unet.config, h // 8, w // 8, frames)
    want_flash = flash_launches_per_unet_call(pipe.unet.config, h // 8, w // 8, ctx.shape[1],
                                              2 * frames)
    return dict(phase="unet3d_check", rel_err_kernel_vs_fp32=err_kernel,
                rel_err_plain_vs_fp32=err_plain, tattn_launches=launches,
                tattn_launches_expected=want, flash_launches=flash_launches,
                flash_launches_expected=want_flash, group_norm_launches=norm_launches,
                group_norm_launches_expected=norms, group_norm_launches_plain=off_kernel,
                temporal_layers=len(temporal), temporal_inputs_channels_last=sum(inputs_cl),
                video_views=len(in_place), video_views_in_place=sum(in_place),
                ok=bool(torch.isfinite(routed).all()) and launches == want
                and flash_launches == want_flash and flash_launches > 0
                and norm_launches == norms > 0 and off_kernel == 0
                and inputs_cl == [True] * len(temporal) and in_place and all(in_place)
                and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)


def phase_video_profile(pipe, dev):
    """Where a ZeroScope denoise step's device time goes: one torch.profiler
    pass over three full-size CFG UNet3D calls (batch 2, 16 frames, 576x320)
    routed as the main path routes them; a denoise step is one such call."""
    import torch

    h, w, frames = VIDEO_HW_FRAMES
    g = torch.Generator(device=dev).manual_seed(8)
    lat = torch.randn((2, frames, h // 8, w // 8, 4), generator=g, device=dev)
    ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([VIDEO_CAPTION])])
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)

    def call():
        with torch.inference_mode():
            pipe.unet(lat, t, ctx)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / 3
    return dict(phase="video_step_profile", model="zeroscope UNet3D 576x320x16, CFG batch 2",
                **_device_profile(call, seconds, top=12), ok=True)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

VIDEO_SHARDED_MESH = (2, 4)            # the (cfg, sp) mesh the computed rows are for
# The 40-step latents of the fp32 copy (plain attention, no TF32) through the
# sharded loop at the world of one against the unsharded loop, relative L2:
# the 2e-4 that tests/test_torch_video_sharded.py holds 6 fp32 steps to. The
# two differ only in the frame-split arithmetic (two-pass GroupNorms, halo
# convs, the reshard), so what the bf16 paths part by beyond this is rounding
# carried through the steps.
VIDEO_SHARDED_FP32_REL = 2e-4


def video_sharded_bytes(cfg, lat_h: int, lat_w: int, frames: int, videos: int, n_cfg: int,
                        n_sp: int, elem: int) -> dict:
    """What one inner rank of a (cfg, sp) mesh sends in one denoise step of
    pipelines/vd.py's sharded loop, COMPUTED from the UNet3D configuration
    (not timed): each TransformerTemporal's all-to-all pair (n_sp - 1 of its
    n_sp chunks of [rows, F / n_sp, ceil(P / n_sp), C], there and back), each
    TemporalConv's four halos (a [rows, C, P] frame to each neighbour), the
    temporal GroupNorms' two all-reduced [rows, groups] fp32 moments (the
    payload), and the cfg join of the noise prediction [rows, F / n_sp, h, w,
    out]. rows = 2 * videos / n_cfg; elem: bytes of the UNet's dtype."""
    rows, fl = 2 * videos // n_cfg, frames // n_sp
    tt, tc = unet3d_temporal_layers(cfg)
    a2a = halo = norm = 0
    for lvl, P in enumerate(unet3d_level_pixels(cfg, lat_h, lat_w)):
        C = cfg.block_out_channels[lvl]
        a2a += tt[lvl] * 2 * (n_sp - 1) * rows * fl * -(-P // n_sp) * C * elem
        halo += tc[lvl] * 4 * min(n_sp - 1, 2) * rows * C * P * elem
        if n_sp > 1:
            norm += (tt[lvl] + 4 * tc[lvl]) * 2 * rows * cfg.norm_num_groups * 4
    join = (n_cfg - 1) * rows * fl * lat_h * lat_w * cfg.out_channels * elem
    return dict(all_to_all_bytes=a2a, halo_bytes=halo, group_norm_bytes=norm,
                cfg_join_bytes=join, total_bytes=a2a + halo + norm + join)


def sharded_tattn_cases(cfg, lat_h: int, lat_w: int, frames: int, videos: int, n_cfg: int,
                        n_sp: int):
    """The temporal attention shapes one rank of a (cfg, sp) mesh runs: every
    frame of ceil(P / n_sp) pixels (padded) at each level that holds a
    TransformerTemporal, in TATTN_CASES' form."""
    tt, _ = unet3d_temporal_layers(cfg)
    names = [f"L{lvl}" for lvl in range(len(tt) - 1)] + ["mid"]
    out = []
    for lvl, P in enumerate(unet3d_level_pixels(cfg, lat_h, lat_w)):
        if not tt[lvl]:
            continue
        C, H = cfg.block_out_channels[lvl], cfg.num_attention_heads[lvl]
        out.append((f"sharded_cfg{n_cfg}_sp{n_sp}_{names[lvl]}_P{-(-P // n_sp)}_D{C // H}",
                    2 * videos // n_cfg, frames, -(-P // n_sp), C, H, "bfpc"))
    return out


def phase_video_sharded(pipe, dev, smi: str):
    """The sharded video denoise and decode (pipelines/vd.py ``__call__(mesh=)``)
    on one card: the temporal kernel at the shapes one rank of a cfg 2 x sp 4
    mesh gives it, with the bytes such a rank would send a step (computed);
    then, over the NCCL world of one (a cfg 1 x sp 1 mesh), one CFG UNet3D
    call through the frame-split code (two-pass GroupNorms, halo convs, the
    frame/pixel reshard) and the plain call, each against an fp32 copy (the
    unet_check rule), and the whole ZeroScope call (576x320, 16 frames, 40
    steps, CFG 7.5) sharded and unsharded on the same latents: seconds, the
    frames, launches by route equal, and the denoised latents of each against
    the same 40 steps through the fp32 copy (the unet_check rule again: over
    40 steps at CFG 7.5 two bf16 paths part by several percent, so the rule is
    relative to what the unsharded path's own rounding gives); and the same
    40 steps through the fp32 copy sharded, against the unsharded fp32 steps
    within VIDEO_SHARDED_FP32_REL. Leaves the process group up (the parallel
    phase joins it)."""
    import dataclasses

    import torch

    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models.unet3d import UNet3DConditionModel
    from spider_tpu_torch.ops.attention import spatial_flash_config
    from spider_tpu_torch.ops.temporal_attention import temporal_attention_config
    from spider_tpu_torch.parallel.collectives import group_of

    h, w, frames = VIDEO_HW_FRAMES
    cfg = pipe.unet.config
    n_cfg, n_sp = VIDEO_SHARDED_MESH
    rows = []
    for row in phase_kernel_tattn(dev, sharded_tattn_cases(cfg, h // 8, w // 8, frames, 1,
                                                           n_cfg, n_sp)):
        rows.append(dict(phase="video_sharded", part="kernel", nvidia_smi=smi, **row))
    rows.append(dict(phase="video_sharded", part="bytes_per_step_computed",
                     mesh=dict(cfg=n_cfg, sp=n_sp), videos=1, dtype="bfloat16",
                     **video_sharded_bytes(cfg, h // 8, w // 8, frames, 1, n_cfg, n_sp, 2),
                     ok=True, nvidia_smi=smi))

    dist.init_distributed_mode(dev)
    mesh = dist.make_video_mesh(cfg=1, sp=1)
    g = torch.Generator(device=dev).manual_seed(9)
    lat = torch.randn((2, frames, h // 8, w // 8, 4), generator=g, device=dev)
    ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([VIDEO_CAPTION])])
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ref_unet = UNet3DConditionModel(dataclasses.replace(cfg, dtype=torch.float32), dev).eval()
    ref_unet.load_state_dict(pipe.unet.state_dict())
    start = lat[:1].clone()
    with torch.inference_mode():
        sharded = pipe.unet(lat, t, ctx, sp_group=group_of(mesh, ("sp",))).float()
        plain = pipe.unet(lat, t, ctx).float()
    bf16_unet, pipe.unet = pipe.unet, ref_unet          # the fp32 copy, plain attention
    try:
        with torch.inference_mode(), temporal_attention_config("plain"), \
                spatial_flash_config("einsum"):
            ref = ref_unet(lat, t, ctx.float())
            fp32 = pipe._denoise_fn(STEPS, GUIDANCE, tuple(start.shape))(
                start, ctx[1:].float(), ctx[:1].float())        # 40 steps: cond, uncond
            fp32_sharded = pipe._denoise_fn_sharded(STEPS, GUIDANCE, tuple(start.shape), mesh)(
                start, ctx[1:].float(), ctx[:1].float())
    finally:
        pipe.unet = bf16_unet
    del ref_unet
    torch.cuda.empty_cache()
    err_sharded, err_plain = _rel_errors(sharded, plain, ref)
    rows.append(dict(phase="video_sharded", part="unet3d_check",
                     rel_err_sharded_vs_fp32=err_sharded, rel_err_unsharded_vs_fp32=err_plain,
                     nvidia_smi=smi, ok=bool(torch.isfinite(sharded).all())
                     and err_sharded <= UNET_REL_SLACK * err_plain + 1e-3))
    del sharded, plain, ref
    fp32_rel = ((fp32_sharded - fp32).norm() / fp32.norm()).item()
    rows.append(dict(phase="video_sharded", part="fp32_sharded_vs_unsharded", steps=STEPS,
                     latent_rel_l2=fp32_rel,
                     latent_max_abs_diff=(fp32_sharded - fp32).abs().max().item(),
                     bound_rel_l2=VIDEO_SHARDED_FP32_REL, nvidia_smi=smi,
                     ok=bool(torch.isfinite(fp32_sharded).all())
                     and fp32_rel <= VIDEO_SHARDED_FP32_REL))
    del fp32_sharded

    seen = {}
    for name, kw, decode in (("unsharded", {}, "_decode_latents"),
                             ("sharded", dict(mesh=mesh), "_decode_latents_sharded")):
        real = getattr(pipe, decode)

        def record(latents, *rest, name=name, real=real):
            seen[name] = latents.clone()
            return real(latents, *rest)

        setattr(pipe, decode, record)
        try:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(prompt=[VIDEO_CAPTION], num_inference_steps=STEPS,
                       guidance_scale=GUIDANCE, height=h, width=w, num_frames=frames,
                       latents=start, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            delattr(pipe, decode)
        launches, routes = read_launches(), read_route_launches()
        seen[name + "_frames"] = out
        rows.append(dict(phase="video_sharded", part=name, seconds=seconds,
                         mesh=dict(cfg=1, sp=1) if kw else None, frames_shape=list(out.shape),
                         frames_dtype=str(out.dtype), launches=launches, route_launches=routes,
                         nvidia_smi=smi, ok=out.shape == (1, frames, h, w, 3)
                         and str(out.dtype) == "uint8" and on_ruled_route(routes)))
    a, b = seen["sharded"], seen["unsharded"]
    err_sharded, err_plain = _rel_errors(a, b, fp32)
    fa, fb = (seen[k + "_frames"].astype("int16") for k in ("sharded", "unsharded"))
    want_tattn = STEPS * tattn_launches_per_unet3d_call(cfg, h // 8, w // 8, frames)
    same = (rows[-1]["launches"] == rows[-2]["launches"]
            and rows[-1]["route_launches"] == rows[-2]["route_launches"])
    rows.append(dict(phase="video_sharded", part="sharded_vs_unsharded",
                     latent_rel_l2=((a - b).norm() / b.norm()).item(),
                     latent_max_abs_diff=(a - b).abs().max().item(),
                     latent_rel_err_sharded_vs_fp32=err_sharded,
                     latent_rel_err_unsharded_vs_fp32=err_plain,
                     frames_mean_abs_levels=float(abs(fa - fb).mean()),
                     frames_max_abs_levels=int(abs(fa - fb).max()),
                     tattn_launches=rows[-1]["launches"]["tattn_fwd"],
                     tattn_launches_expected=want_tattn, launches_equal=same, nvidia_smi=smi,
                     ok=bool(torch.isfinite(a).all())
                     and err_sharded <= UNET_REL_SLACK * err_plain + 1e-3
                     and same and rows[-1]["launches"]["tattn_fwd"] == want_tattn))
    return rows


def timed_chat(chat_fn, prompt):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = chat_fn(prompt)
    torch.cuda.synchronize()
    return text, time.perf_counter() - t0


def chat_attention_row(model) -> dict:
    """A measured row, no routing change: the attention of one contiguous
    chat decode step (models/llama.py: mha_reference over the whole cache,
    masked by kv_len) at B 1 and 1758 live keys of a 1792-key cache, beside
    the split paged kernel over the same cache seen as 14 pages of 128 keys
    through an identity page table. Device ms; these launches are made
    before the phase's counts are set to 0."""
    import torch

    from spider_tpu_torch.ops.attention import mha_reference
    from spider_tpu_torch.ops.paged_attention import paged_decode_kernel

    cfg, dev = model.config, model.device
    Hq, Hkv, D, S, live, page = (cfg.num_attention_heads, cfg.num_key_value_heads,
                                 cfg.head_dim_, 1792, 1758, 128)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((1, 1, Hq, D), generator=g, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((1, S, Hkv, D), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    kv_len = torch.tensor([live], dtype=torch.int32, device=dev)
    table = torch.arange(S // page, dtype=torch.int32, device=dev)[None]
    pools = [x.reshape(S // page, page, Hkv, D) for x in (k, v)]
    plain = lambda: mha_reference(q, k, v, causal=False, kv_len=kv_len)
    split = lambda: paged_decode_kernel(q[:, 0], *pools, table, kv_len, route="split")
    err = (split().float() - plain()[:, 0].float()).abs().max().item()
    row = dict(keys=live, cache=S, mha_reference_device_ms=device_ms(plain),
               split_device_ms=device_ms(split), max_abs_diff=err)
    row["split_is_faster"] = row["split_device_ms"] < row["mha_reference_device_ms"]
    return row


def phase_chat(model, tokenizer, spider_free_T: int):
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    prompt = CHAT_PROMPT
    assert len(tokenizer(prompt).input_ids) == PROMPT_TOKENS
    long_prompt = ("x" * (spider_free_T - 1))
    first = make_llama_chat_fn(model, tokenizer, max_new_tokens=1)
    full = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
    attention_row = chat_attention_row(model)
    reset_launches()
    timed_chat(first, prompt)                     # warm-up
    prefill_s = min(timed_chat(first, prompt)[1] for _ in range(3))
    prefill_long_s = min(timed_chat(first, long_prompt)[1] for _ in range(3))
    text, total_s = timed_chat(full, prompt)
    launches, routes = read_launches(), read_route_launches()
    decode_s = total_s - prefill_s
    return dict(phase="chat", model="llama3_8b int8 weight-only (random weights)",
                contiguous_vs_split=attention_row,
                prompt_tokens=PROMPT_TOKENS, new_tokens=NEW_TOKENS,
                prefill_ms_T128=prefill_s * 1e3,
                prefill_ms_T_spider_free=prefill_long_s * 1e3,
                spider_free_prompt_tokens=spider_free_T,
                generate_s=total_s, decode_tok_s=(NEW_TOKENS - 1) / decode_s,
                launches=launches, route_launches=routes, text_chars=len(text),
                ok=launches["flash_fwd"] > 0 and isinstance(text, str)
                and on_ruled_route(routes) and attention_row["max_abs_diff"] <= OUT_ATOL)


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
    want_image = STEPS * flash_launches_per_unet_call(pipe.unet.config, 64, 64, 77, 2)
    rows = []
    for r in range(REQUESTS):
        timing.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = sf.chat(f"Show me {SD_CAPTION}.", task_prompt="IMAGE")[0]
        total = time.perf_counter() - t0
        launches, routes = read_launches(), read_route_launches()
        kinds = [k for k, _ in events]
        images = [p["media"] for k, p in events if k == "image"]
        ok = (kinds == ["text", "image"] and len(images) == 1 and on_ruled_route(routes)
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
                         image_range=timing.get("image_range"), launches=launches,
                         route_launches=routes, ok=ok))
    return rows


A2M_QUESTION = f"Show me {SD_CAPTION}, let me hear it and film it."
A2M_TAGS = (f" <IMAGE>{SD_CAPTION}</IMAGE> <AUDIO>{AUDIO_CAPTION}</AUDIO>"
            f" <VIDEO>{VIDEO_CAPTION}</VIDEO>")
A2M_SEEDS = {"IMAGE": 1, "AUDIO": 2, "VIDEO": 3}


def any_to_many_want(sd, ad, vd) -> dict:
    """What the configurations say one any-to-many request's decoders must
    show: flash and temporal launches per decoder, media shapes."""
    from spider_tpu_torch.models.vocoder import output_length

    h, w, frames = VIDEO_HW_FRAMES
    lat = ad.latent_shape(1, AUDIO_SECONDS)
    mel_frames = lat[1] * 2 ** (len(ad.vae.config.block_out_channels) - 1)
    return dict(
        image_flash=STEPS * flash_launches_per_unet_call(sd.unet.config, 64, 64, 77, 2),
        audio_flash=STEPS * flash_launches_per_unet_call(ad.unet.config, lat[1], lat[2],
                                                           1, 2),
        video_tattn=STEPS * tattn_launches_per_unet3d_call(vd.unet.config, h // 8, w // 8,
                                                           frames),
        video_flash=STEPS * flash_launches_per_unet_call(vd.unet.config, h // 8, w // 8, 77,
                                                         2 * frames),
        audio_shape=[1, output_length(ad.vocoder.config, mel_frames)],
        video_shape=[1, frames, h, w, 3])


def any_to_many_spider_free(model, tokenizer, sd, ad, vd, timing: dict):
    """SpiderFree over the 8B chat backbone, whose answer gets the fixed tag
    spans appended, and the three timed decoders, recording into `timing`."""
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    llm_chat = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)

    def chat_fn(prompt):
        text, s = timed_chat(llm_chat, prompt)
        timing["chat_s"] = s
        return text + A2M_TAGS

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    return SpiderFree(cfg, chat_fn=chat_fn, decoders={
        m: _timed_decoder(pipe, m.lower(), timing, seed=A2M_SEEDS[m])
        for m, pipe in (("IMAGE", sd), ("AUDIO", ad), ("VIDEO", vd))})


def any_to_many_decoders_ok(timing: dict, want: dict) -> bool:
    """Each decoder's output shape, range and launches, and the operating
    point it was called at."""
    h, w, frames = VIDEO_HW_FRAMES
    return bool(
        timing.get("image_shape") == [1, 512, 512, 3] and timing["image_finite"]
        and 0.0 <= timing["image_range"][0] and timing["image_range"][1] <= 1.0
        and timing["image_launches"]["flash_fwd"] == want["image_flash"]
        and timing.get("audio_shape") == want["audio_shape"] and timing["audio_finite"]
        and -1.0 <= timing["audio_range"][0] and timing["audio_range"][1] <= 1.0
        and timing["audio_launches"]["flash_fwd"] == want["audio_flash"]
        and timing.get("audio_kw") == dict(guidance_scale=GUIDANCE, num_inference_steps=STEPS,
                                           audio_length_in_s=AUDIO_SECONDS)
        and timing.get("video_shape") == want["video_shape"]
        and timing["video_dtype"] == "uint8"
        and timing["video_launches"]["tattn_fwd"] == want["video_tattn"]
        and timing["video_launches"]["flash_fwd"] == want["video_flash"]
        and timing.get("video_kw") == dict(guidance_scale=GUIDANCE, num_inference_steps=STEPS,
                                           height=h, width=w, num_frames=frames))


def phase_any_to_many(model, tokenizer, sd, ad, vd):
    import torch

    timing = {}
    sf = any_to_many_spider_free(model, tokenizer, sd, ad, vd, timing)
    want = any_to_many_want(sd, ad, vd)
    rows = []
    for r in range(ANY_TO_MANY_REQUESTS):
        timing.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = sf.chat(A2M_QUESTION, task_prompt="SMARTMULTIMODAL")[0]
        total = time.perf_counter() - t0
        launches, routes = read_launches(), read_route_launches()
        kinds = [k for k, _ in events]
        media = {k: p["media"] for k, p in events if k != "text"}
        ok = (on_ruled_route(routes)
              # the controller dispatches in its key order: IMAGE, VIDEO, AUDIO
              and kinds == ["text", "image", "video", "audio"]
              and media["image"].shape == (512, 512, 3)
              and any_to_many_decoders_ok(timing, want))
        rows.append(dict(
            phase="any_to_many", request=r, warm_up=r == 0, events=kinds, seconds=total,
            chat_s=timing.get("chat_s"), image_s=timing.get("image_s"),
            audio_s=timing.get("audio_s"), video_s=timing.get("video_s"),
            image_launches=timing.get("image_launches"),
            audio_launches=timing.get("audio_launches"),
            video_launches=timing.get("video_launches"), expected=want,
            audio_shape=timing.get("audio_shape"), audio_range=timing.get("audio_range"),
            video_shape=timing.get("video_shape"), video_dtype=timing.get("video_dtype"),
            launches=launches, route_launches=routes, ok=ok))
    return rows


def _read_sse(resp, t0: float):
    """(events, seconds from t0 at which each arrived) of a server-sent
    event stream, up to its 'done' event."""
    events, at = [], []
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            events.append(json.loads(line[len(b"data: "):]))
            at.append(time.perf_counter() - t0)
            if events[-1]["kind"] == "done":
                break
    return events, at


def _decoded_media(events) -> dict:
    """Shapes of the media of serialized events, decoded: PNG images and
    video frames through PIL, the WAV through the wave module."""
    import base64
    import io
    import wave

    import numpy as np
    from PIL import Image

    def png(b64):
        return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))

    out = {}
    for ev in events:
        if ev["kind"] == "image":
            out["image"] = list(png(ev["data"]).shape)
        elif ev["kind"] == "video":
            frames = [png(f) for f in ev["data"]]
            out["video"] = [len(frames)] + list(frames[0].shape)
        elif ev["kind"] == "audio":
            with wave.open(io.BytesIO(base64.b64decode(ev["data"]))) as w:
                out["audio"] = [w.getnframes()]
    return out


def phase_http(model, tokenizer, sd, ad, vd):
    """The any-to-many request through serving/http_server.py: one streamed
    POST /chat (server-sent events, the seconds to each event) and one
    answered in one JSON body, on the resident models."""
    import http.client

    import PIL
    import torch

    from spider_tpu_torch.serving.http_server import serve

    timing = {}
    sf = any_to_many_spider_free(model, tokenizer, sd, ad, vd, timing)
    want = any_to_many_want(sd, ad, vd)
    L = model.config.num_hidden_layers
    want_flash = L + want["image_flash"] + want["audio_flash"] + want["video_flash"]
    h, w, frames = VIDEO_HW_FRAMES
    want_media = dict(image=[512, 512, 3], video=[frames, h, w, 3],
                      audio=[want["audio_shape"][1]])
    server = serve(sf, port=0, background=True)
    rows = []
    try:
        for stream in (True, False):
            body = json.dumps(dict(text=A2M_QUESTION, task="SMARTMULTIMODAL", stream=stream))
            timing.clear()
            reset_launches()
            torch.cuda.synchronize()
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=600)
            t0 = time.perf_counter()
            conn.request("POST", "/chat", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            if stream:
                events, at = _read_sse(resp, t0)
                answer = next((e["answer"] for e in events if e["kind"] == "text"), None)
            else:
                out = json.loads(resp.read())
                events, answer = out["events"], out["answer"]
            total = time.perf_counter() - t0
            conn.close()
            launches, routes = read_launches(), read_route_launches()
            kinds = [e["kind"] for e in events]
            media = _decoded_media(events)
            row = dict(phase="http", stream=stream, status=resp.status, events=kinds,
                       seconds=total, chat_s=timing.get("chat_s"),
                       image_s=timing.get("image_s"), audio_s=timing.get("audio_s"),
                       video_s=timing.get("video_s"), media=media, media_expected=want_media,
                       pil=PIL.__version__, launches=launches, route_launches=routes,
                       flash_expected=want_flash, answer_chars=len(answer or ""))
            ok = (resp.status == 200 and media == want_media and on_ruled_route(routes)
                  and any_to_many_decoders_ok(timing, want)
                  and launches["flash_fwd"] == want_flash
                  and launches["tattn_fwd"] == want["video_tattn"])
            if stream:
                row["seconds_to"] = dict(zip(kinds, at))
                ok &= kinds == ["text", "image", "video", "audio", "done"]
                first = dict(answer=answer, media={e["kind"]: e.get("data") for e in events})
            else:
                ok &= kinds == ["image", "video", "audio"] and answer == first["answer"]
                row["same_media_as_stream"] = {e["kind"]: e["data"] == first["media"][e["kind"]]
                                               for e in events}
            row["ok"] = bool(ok)
            rows.append(row)
    finally:
        server.shutdown()
        server.server_close()
    return rows


def phase_orchestrator(sd, ad, vd, dev):
    """The three decoder stages of one any-to-many request, one after another
    and then through serving/orchestrator.py (StageOrchestrator,
    run_request_concurrent), each stage on its own thread and CUDA stream:
    the same seeds, so the same media bit for bit (cuDNN on its deterministic
    algorithms for this phase)."""
    import numpy as np
    import torch

    from spider_tpu_torch.serving.orchestrator import dryrun_concurrent

    h, w, frames = VIDEO_HW_FRAMES
    want = any_to_many_want(sd, ad, vd)

    def stage(pipe, seed, **kw):
        def fn(s):
            g = torch.Generator(device=dev).manual_seed(seed)
            return pipe(prompt=s["llm_text_res"], generator=g, guidance_scale=GUIDANCE,
                        num_inference_steps=STEPS, **kw)
        return fn

    pipes = {"IMAGE": stage(sd, A2M_SEEDS["IMAGE"]),
             "VIDEO": stage(vd, A2M_SEEDS["VIDEO"], height=h, width=w, num_frames=frames),
             "AUDIO": stage(ad, A2M_SEEDS["AUDIO"], audio_length_in_s=AUDIO_SECONDS)}
    # The HiFi-GAN's transposed convolutions run on cuDNN algorithms that may
    # sum in any order: two serial clips, before cuDNN is held to its
    # deterministic algorithms for the bit comparison below.
    probe = {"llm_text_res": [AUDIO_CAPTION]}
    audio_twice_equal = bool(np.array_equal(pipes["AUDIO"](probe), pipes["AUDIO"](probe)))
    runs = 2                      # the serial run, the concurrent run (all warm here)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        torch.cuda.synchronize()
        stats = dryrun_concurrent(pipes, device=dev, repeats=1,
                                  samples={"llm_text_all": ["Here." + A2M_TAGS]})
        launches, routes = read_launches(), read_route_launches()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want_flash = runs * (want["image_flash"] + want["audio_flash"] + want["video_flash"])
    same = [m1 == m2 and c1 == c2 and np.array_equal(a, b) for (m1, c1, a), (m2, c2, b)
            in zip(stats["serial_events"], stats["events"])]
    shapes = {m: list(a.shape) for m, _, a in stats["events"]}
    ok = (len(same) == 3 and all(same) and on_ruled_route(routes)
          and launches["flash_fwd"] == want_flash
          and launches["tattn_fwd"] == runs * want["video_tattn"]
          and all(sum(routes[n].values()) == launches[n] for n in ROUTED)
          and shapes == dict(IMAGE=[1, 512, 512, 3], AUDIO=want["audio_shape"],
                             VIDEO=want["video_shape"]))
    return dict(phase="orchestrator", stages=list(pipes), runs=runs,
                serial_s=stats["serial_s"], concurrent_s=stats["concurrent_s"],
                overlap_x=stats["overlap_x"], stage_done_s=stats["stage_s"],
                cudnn_deterministic=True, audio_twice_equal_by_default=audio_twice_equal,
                media_bit_equal=same, shapes=shapes, launches=launches,
                route_launches=routes, flash_expected=want_flash,
                tattn_expected=runs * want["video_tattn"], ok=bool(ok))


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
        launches, routes = read_launches(), read_route_launches()
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
            tattn_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0, group_norm=0)
        got = [emitted[id(f)] for f in futs[:SERVING_WARMUP]]
        ref = _greedy_tokens(model, tokenizer, prompts[:SERVING_WARMUP], n_new)
        leading = []
        for a, b in zip(got, ref):
            n = 0
            while n < min(len(a), len(b)) and a[n] == b[n]:
                n += 1
            leading.append(n)
        want_int4 = (int4_route_counts(cfg, steps, prefills) if cfg.quantization == "int4"
                     else dict(stream=0, wgmma=0, mma=0))
        ok = (all(isinstance(o, str) for o in warm + outs) and drained and not alive
              and launches == want and on_ruled_route(routes)
              and routes["int4_matmul"] == want_int4)
        rows.append(dict(
            phase="serving", config=name, model=f"llama3_8b {cfg.quantization}",
            requests=SERVING_REQUESTS, new_tokens=n_new, seconds=seconds,
            tok_s=SERVING_REQUESTS * n_new / seconds,
            # the same row of the last full run before this kernel redesign
            # (NVIDIA H100 80GB HBM3, 700.00 W; host-bound, so it moves between runs)
            earlier_tok_s=SERVING_EARLIER_TOK_S[name],
            emitted_tokens=sum(len(emitted[id(f)]) for f in futs),
            decode_steps=steps, prefills=prefills,
            n_preempts=getattr(cb, "n_preempts", None), pool_drained=drained,
            launches=launches, launches_expected=want, route_launches=routes,
            leading_tokens_equal_generate=leading, ok=ok))
        del cb
        torch.cuda.empty_cache()
    rows.append(serving_decode_profile(model4))
    return rows


def serving_decode_profile(model) -> dict:
    """Device ms of one decode step of the paged int4 batcher's model call:
    16 slots over a pool of 128-key pages, 225 int4 and 32 paged launches,
    from a torch.profiler pass (device rows only). Not a main-path run: its
    launches are not counted."""
    import torch

    from spider_tpu_torch.models.llama import init_paged_kv_cache

    cfg, dev = model.config, model.device
    S, page, MP = 16, 128, 4
    g = torch.Generator(device=dev).manual_seed(12)
    pool = init_paged_kv_cache(cfg, 1 + S * MP, page, device=dev)
    for p in pool:
        p.normal_(generator=g)
    table = (1 + torch.randperm(S * MP, generator=g, device=dev)).reshape(S, MP).int()
    kv = torch.randint(40, 400, (S,), generator=g, device=dev, dtype=torch.int32)
    tok = torch.randint(3, cfg.vocab_size, (S, 1), generator=g, device=dev)

    def step():
        with torch.inference_mode():
            model(input_ids=tok, positions=kv[:, None], kv_write_index=kv, kv_cache=pool,
                  kv_len=kv + 1, page_table=table)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    unprofiled_s = (time.perf_counter() - t0) / 5
    before = read_launches()
    profile = _device_profile(step, unprofiled_s, steps=3,
                              watch=("int4_stream", "int4_wgmma", "int4_matmul_kernel", "paged"))
    per_step = {n: (c - before[n]) / 3 for n, c in read_launches().items()}
    del pool
    torch.cuda.empty_cache()
    return dict(phase="serving", config="decode_step_profile_bs16_int4",
                model=f"llama3_8b {cfg.quantization}", slots=S, **profile,
                # with the first int4 and paged kernels, same card model and limit
                earlier_device_ms_per_step=9.5,
                launches_per_step=per_step, launches=dict.fromkeys(KERNELS, 0),
                ok=profile["device_ms"] > 0 and per_step["int4_matmul"]
                == 7 * cfg.num_hidden_layers + 1
                and per_step["paged_decode"] == cfg.num_hidden_layers)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _checksum(t) -> int:
    """An exact fingerprint of a tensor's bits."""
    import torch

    view = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return int(t.detach().contiguous().view(view).sum(dtype=torch.int64))


def _device_profile(fn, unprofiled_s: float, steps: int = 3, top: int = 8,
                    watch=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "tattn")) -> dict:
    """One torch.profiler pass over `steps` calls of fn(): device time by
    kernel name (device rows only), and `device_busy_share_profiled`, the
    share of those same calls' wall time that the device is busy. Only the
    device's activity is recorded, yet the tracing still slows the host's
    launches, so that share is a lower bound for an unprofiled step;
    `profiled_s_per_step` is what these calls took. Given the unprofiled
    time of a step, `device_busy_share_unprofiled` divides the profiled
    steps' device time by it: two different sets of steps, which is sound as
    far as a step's device time repeats (hold `device_ms_per_step` against
    other runs). `watched` sums the rows whose kernel name holds each string
    of `watch`: the port's own kernels, wherever they rank."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def once(activities):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        return wall_ms, sorted(rows, key=lambda r: -r[1])

    recorded = "device"
    wall_ms, rows = once([ProfilerActivity.CUDA])
    if not rows:                 # this profiler build needs the host's events too
        recorded = "host+device"
        wall_ms, rows = once([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    total = sum(r[1] for r in rows)
    return dict(steps=steps, recorded=recorded, profiled_wall_ms=wall_ms, device_ms=total,
                profiled_s_per_step=wall_ms / steps / 1e3, device_ms_per_step=total / steps,
                unprofiled_s_per_step=unprofiled_s,
                device_busy_share_profiled=total / wall_ms if total else None,
                device_busy_share_unprofiled=(total / steps / (unprofiled_s * 1e3)
                                              if total else None),
                device_kernels_per_step=sum(r[2] for r in rows) / steps,
                watched={w: dict(ms=sum(r[1] for r in rows if w in r[0]) / steps,
                                 launches=sum(r[2] for r in rows if w in r[0]) / steps)
                         for w in watch},
                top=[dict(kernel=k[:80], ms=ms / steps, launches=n / steps, share=ms / total)
                     for k, ms, n in rows[:top]])


def train_config(out_dir: str):
    """What `python -m spider_tpu_torch.train <config>` reads from a recipe
    file: the full preset of train_configs/spider_demo_train_full.py with
    SAM ViT-H for the MASK branch, on the three synthetic dataset twins at
    batch 4. The rate stays at init_lr (decay 1.0), so the later steps still
    move the weights."""
    from spider_tpu_torch.common.config import Config

    return Config.fromdict(dict(
        model=dict(type="spider", preset="full", lora_r=32, with_sam=True),
        datasets=dict(
            t2i_cc_sbu=dict(batch_size=TRAIN_BATCH,
                            build_info=dict(image_size=TRAIN_IMAGE_SIZE, seed=1)),
            i2t_cc_sbu=dict(batch_size=TRAIN_BATCH,
                            build_info=dict(image_size=TRAIN_IMAGE_SIZE, seed=2)),
            t2a_audiocap=dict(batch_size=TRAIN_BATCH,
                              build_info=dict(num_mels=TRAIN_MEL_BINS,
                                              target_length=TRAIN_MEL_FRAMES, seed=3))),
        run=dict(task="image_text_pretrain", runner="runner_base",
                 lr_sched="linear_warmup_step_lr", init_lr=3e-4, lr_decay_rate=1.0,
                 warmup_steps=0, max_epoch=1, iters_per_epoch=TRAIN_EPOCH_ITERS,
                 log_freq=TRAIN_EPOCH_ITERS, seed=42, weight_decay=0.01, max_grad_norm=1.0,
                 accum_grad_iters=1, num_frozen_embed_rows=FROZEN_ROWS,
                 length_bucket=TRAIN_BUCKET, output_dir=out_dir)))


def batch_tokens(spider, samples, bucket: int):
    """(padded, live, supervised) tokens of a batch as the step sees it:
    padded to the length bucket; up to each sample's last token; with a
    target."""
    from spider_tpu_torch.models.spider import pad_to_bucket

    pad = spider.tokenizer.pad_token_id
    batch = pad_to_bucket(spider.prepare_batch(samples), bucket, pad)
    slots = sum(batch.slot_mask.values()) > 0 if batch.slot_mask else False
    real = (batch.input_ids != pad) | slots
    last = real.shape[1] - real[:, ::-1].argmax(axis=1)
    return (int(batch.input_ids.size), int(last[real.any(axis=1)].sum()),
            int((batch.targets != -100).sum()))


def phase_train(sd, ad, vd, dev, smi: str):
    """The training path at full width, through the train entry's own
    build_runner (task -> datasets -> build_spider_from_config(preset='full')
    -> the registered runner) and RunnerBase.train_epoch / train. Returns
    (rows, launches, handoff): the JSON rows, the main path's launch counts
    (the epochs and the timed and checked train steps; launches made while
    profiling or routed to the plain backward are left out) and what
    phase_spider_generate serves: the config, the checkpoint RunnerBase.train()
    wrote and its directory, which the caller removes."""
    import logging
    import shutil
    import signal
    import tempfile

    import torch

    from spider_tpu_torch import train as T
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.registry import registry
    from spider_tpu_torch.datasets.utils.loaders import batched
    from spider_tpu_torch.ops import attention as A
    from spider_tpu_torch.runners.train_step import build_optimizer, make_lm_train_step

    rows = []
    launches = dict.fromkeys(KERNELS, 0)
    routes = {name: dict.fromkeys(by_route, 0)
              for name, by_route in read_route_launches().items()}
    out_dir = tempfile.mkdtemp(prefix="spider_train_")
    sigterm = signal.getsignal(signal.SIGTERM)

    def add(counts):
        """Add the counts just read, and the same launches by route, to the
        main path's totals."""
        for name in KERNELS:
            launches[name] += counts[name]
        for name, by_route in read_route_launches().items():
            for route, n in by_route.items():
                routes[name][route] += n

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    def finite(values):
        return all(v == v and abs(v) != float("inf") for v in values)

    try:
        torch.cuda.reset_peak_memory_stats()
        resident_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        cfg = train_config(out_dir)
        runner = T.build_runner(cfg, dev, "chip_smoke")
        # the entry logs to the standard output, which here carries the JSON lines
        for handler in logging.getLogger().handlers:
            if getattr(handler, "stream", None) is sys.stdout:
                handler.setStream(sys.stderr)
        torch.cuda.synchronize()
        spider, task, datasets = runner.model, runner.task, runner.datasets
        # the decoders' text conditioning is the alignment target: the resident
        # pipelines, not second copies built by with_pipes
        spider.diffusion_pipes.update(IMAGE=sd, VIDEO=vd, AUDIO=ad)
        loaders = {name: batched(iter(entry["dataset"]), entry["batch_size"])
                   for name, entry in datasets["train"].items()}
        llm_cfg = spider.llm.config
        L = llm_cfg.num_hidden_layers
        want = dict.fromkeys(KERNELS, 0)
        want.update(flash_fwd=L * (1 + llm_cfg.remat), flash_bwd_dq=L, flash_bwd_dkv=L)
        trainable = spider.trainable_params()
        frozen = {n: p for n, p in spider.named_parameters() if n not in trainable}
        n_trainable = sum(p.numel() for p in trainable.values())
        n_frozen = sum(p.numel() for p in frozen.values())
        rows.append(dict(
            phase="train", part="build", seconds=time.perf_counter() - t0,
            entry="spider_tpu_torch.train.build_runner: setup_task -> build_datasets -> "
                  "build_model -> build_spider_from_config(preset='full') -> runner_base",
            model="build_full_spider: llama3_8b architecture, LoRA r 32, vocab "
                  f"{llm_cfg.vocab_size}, bf16 base frozen, remat; imagebind_huge; "
                  "moe_transformer aligner (hidden 512, 3 experts x 4+4 layers); "
                  "sam_vit_h in bf16, its mask decoder trained in fp32",
            trainable_params=n_trainable, frozen_params=n_frozen,
            resident_before_gb=resident_gb, allocated_gb=torch.cuda.memory_allocated() / 1e9,
            ok=type(runner) is registry.get_runner_class("runner_base") and L == 32
            and llm_cfg.hidden_size == 4096 and llm_cfg.lora.r == 32 and llm_cfg.remat
            and spider.encoder is not None and spider.moe_aligner is not None
            and spider.sam is not None))

        # fingerprints of everything that must not move
        sums = {n: _checksum(p) for n, p in frozen.items()}
        vocab = {n: p for n, p in trainable.items()
                 if n.endswith(("embed_tokens.weight", "lm_head.weight"))}
        row_sums = {n: (_checksum(p[:FROZEN_ROWS]), _checksum(p[FROZEN_ROWS:]))
                    for n, p in vocab.items()}

        def token_counts(samples):
            return batch_tokens(spider, samples, TRAIN_BUCKET)

        def timed_step(samples):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runner.train_step(samples)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_launches()
            add(counts)
            return out, seconds, counts

        # ---- one epoch through RunnerBase.train_epoch: MultiIterLoader over the
        # three datasets, the metrics stream. Its first steps warm the card up.
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = runner.train_epoch(0)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = read_launches()
        add(counts)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            stream = [json.loads(line) for line in f]
        rows.append(dict(
            phase="train", part="train_epoch", iters=TRAIN_EPOCH_ITERS, seconds=epoch_s,
            includes="warm-up of the first steps", global_step=runner.global_step,
            metrics_lines=len(stream), losses=[m["loss"] for m in stream],
            lr=[m["lr"] for m in stream], epoch_stats=stats, launches=counts,
            peak_gb=peak_gb(),
            ok=runner.global_step == TRAIN_EPOCH_ITERS and len(stream) == TRAIN_EPOCH_ITERS
            and [m["step"] for m in stream] == list(range(1, TRAIN_EPOCH_ITERS + 1))
            and finite(m["loss"] for m in stream)
            and counts == {k: n * TRAIN_EPOCH_ITERS for k, n in want.items()}))

        # ---- steps cycling IMAGE / TEXT-with-image-input / AUDIO, one task each
        names = ("t2i_cc_sbu", "i2t_cc_sbu", "t2a_audiocap")
        torch.cuda.reset_peak_memory_stats()
        per_task = {name: [] for name in names}
        for i in range(6):
            name = names[i % 3]
            samples = next(loaders[name])
            per_task[name].append(timed_step(samples) + (token_counts(samples),))
        for name, steps in per_task.items():
            secs = statistics.median(s for _, s, _, _ in steps)
            padded, live, supervised = steps[-1][3]
            rows.append(dict(
                phase="train", part="spider_step", dataset=name, batch=TRAIN_BATCH,
                steps=len(steps), s_per_step=secs, s_per_step_all=[s for _, s, _, _ in steps],
                padded_tokens_per_step=padded, live_tokens_per_step=live,
                supervised_tokens_per_step=supervised,
                padded_tokens_per_s=padded / secs, live_tokens_per_s=live / secs,
                losses=[o["loss"] for o, _, _, _ in steps], loss_keys=sorted(steps[-1][0]),
                launches_per_step=steps[-1][2], launches_expected=want, peak_gb=peak_gb(),
                ok=all(finite(o.values()) for o, _, _, _ in steps)
                and all(c == want for _, _, c, _ in steps) and 0 < live <= padded))

        # ---- one repeated batch: the loss falls
        samples = next(loaders["t2i_cc_sbu"])
        losses = []
        for _ in range(8):
            out, _, counts = timed_step(samples)
            losses.append(out["loss"])
        rows.append(dict(phase="train", part="repeated_batch", steps=8, losses=losses,
                         ok=all(x == x for x in losses) and losses[-1] < losses[0]
                         and counts == want))

        # ---- one step's loss and LoRA gradients: kernels vs the plain backward
        def lora_grads():
            spider.zero_grad(set_to_none=True)
            out = runner.loss_dict(samples)
            out["loss"].backward()
            flat = torch.cat([p.grad.float().flatten() for n, p in trainable.items()
                              if "lora_" in n])
            spider.zero_grad(set_to_none=True)
            return float(out["loss"].detach()), flat

        reset_launches()
        loss_k, g_k = lora_grads()
        counts = read_launches()
        add(counts)
        # the same step with the autograd function's backward sent to the plain
        # version, for this one comparison: the package has no such switch
        kernel_backward = A.flash_backward
        A.flash_backward = (lambda q, k, v, out, lse, g, route=None, **kw:
                            A.flash_backward_reference(q, k, v, out, lse, g, **kw))
        try:
            reset_launches()
            loss_p, g_p = lora_grads()
            plain_counts = read_launches()
        finally:
            A.flash_backward = kernel_backward
        rel = ((g_k - g_p).norm() / g_p.norm()).item()
        cos = torch.nn.functional.cosine_similarity(g_k, g_p, dim=0).item()
        rows.append(dict(
            phase="train", part="grad_check", loss_kernels=loss_k, loss_plain=loss_p,
            lora_grad_rel_diff=rel, lora_grad_cosine=cos, lora_grad_norm=g_p.norm().item(),
            lora_grad_elements=g_p.numel(), launches=counts, launches_plain_route=plain_counts,
            bounds=dict(rel=GRAD_REL, cosine=GRAD_COS),
            ok=abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and rel <= GRAD_REL
            and cos >= GRAD_COS and counts == want
            and plain_counts["flash_bwd_dq"] == 0 and plain_counts["flash_bwd_dkv"] == 0
            and bool(torch.isfinite(g_k).all()) and g_p.norm().item() > 0))
        del g_k, g_p

        # ---- the same step once more, every backward made twice on its own
        # inputs: the same bits (one block owns its rows, no atomics). These
        # launches are not the main path's.
        repeats = []

        def backward_twice(*args, **kw):
            first = kernel_backward(*args, **kw)
            again = kernel_backward(*args, **kw)
            repeats.append([bool(torch.equal(a, b)) for a, b in zip(first, again)])
            return first

        A.flash_backward = backward_twice
        try:
            lora_grads()
        finally:
            A.flash_backward = kernel_backward
        rows.append(dict(phase="train", part="backward_same_bits", backwards_repeated=len(repeats),
                         same_bits=dict(zip(("dq", "dk", "dv"), map(sum, zip(*repeats)))),
                         ok=len(repeats) == L and all(map(all, repeats))))

        # ---- MASK: SAM ViT-H in bf16 and frozen; its mask decoder trains from
        # the projected [MASK0] state (2 BCE + 0.5 dice against MASK_GT)
        rows.append(mask_train_step(runner, spider, want, timed_step, add))

        # ---- nothing frozen moved; the new vocabulary rows did
        moved = [n for n, p in frozen.items() if _checksum(p) != sums[n]]
        rows_ok = all(_checksum(p[:FROZEN_ROWS]) == row_sums[n][0]
                      and _checksum(p[FROZEN_ROWS:]) != row_sums[n][1]
                      for n, p in vocab.items())
        rows.append(dict(phase="train", part="frozen_check", frozen_tensors=len(frozen),
                         frozen_tensors_moved=moved[:5], frozen_vocab_rows=FROZEN_ROWS,
                         vocab_matrices=sorted(vocab), optimizer_updates=runner.optimizer.count,
                         ok=not moved and rows_ok and len(vocab) == 2))

        # ---- where a Spider step's time goes
        rows.append(dict(phase="train", part="spider_step_profile", dataset="t2i_cc_sbu",
                         **_device_profile(lambda: runner.train_step(samples),
                                           statistics.median(
                                               s for _, s, _, _ in per_task["t2i_cc_sbu"])),
                         ok=True))
        del runner
        torch.cuda.empty_cache()

        # ---- the LM step (input_ids/labels) at [4, 512]
        B, T_len = TRAIN_LM_SHAPE
        g = torch.Generator(device=dev).manual_seed(11)
        opt = build_optimizer(3e-4, params={n: p for n, p in spider.llm.named_parameters()
                                            if p.requires_grad},
                              weight_decay=0.01, num_frozen_embed_rows=FROZEN_ROWS)
        step = make_lm_train_step(spider.llm, opt)
        spider.train()

        def lm_batch():
            ids = torch.randint(3, llm_cfg.vocab_size, (B, T_len), generator=g, device=dev)
            labels = ids.clone()
            labels[:, : T_len // 4] = -100
            return dict(input_ids=ids, labels=labels)

        step(lm_batch())                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs, metrics, counts_ok = [], [], True
        for _ in range(3):
            batch = lm_batch()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = read_launches()
            add(counts)
            counts_ok &= counts == want
            metrics.append({k: float(v) for k, v in m.items()})
        rows.append(dict(phase="train", part="lm_step", batch=B, seq_len=T_len, steps=3,
                         s_per_step=statistics.median(secs), s_per_step_all=secs,
                         tokens_per_s=B * T_len / statistics.median(secs), metrics=metrics,
                         launches_per_step=counts, launches_expected=want, peak_gb=peak_gb(),
                         ok=finite(v for m in metrics for v in m.values()) and counts_ok))
        batch = lm_batch()
        rows.append(dict(phase="train", part="lm_step_profile", batch=B, seq_len=T_len,
                         **_device_profile(lambda: step(batch), statistics.median(secs)),
                         ok=True))
        del opt, step
        torch.cuda.empty_cache()

        # ---- RunnerBase.train() and a checkpoint round trip, on a runner that
        # trains everything but the two vocabulary matrices (their fp32
        # parameters and Adam state alone would make a 12 GB file)
        cfg.run.trainable_patterns = ("lora_", "llama_proj", "moe_aligner", "logit_scale")
        cfg.run.iters_per_epoch = 2
        os.remove(os.path.join(out_dir, "metrics.jsonl"))
        small = registry.get_runner_class(cfg.run.runner)(
            cfg=cfg, task=task, model=spider, datasets=datasets, job_id="chip_smoke_ckpt")
        runner = small
        reset_launches()
        t0 = time.perf_counter()
        small.train()          # the epoch loop: train_epoch, save_checkpoint, eval_epoch
        train_s = time.perf_counter() - t0
        counts = read_launches()
        add(counts)
        path = os.path.join(out_dir, "checkpoint_0.pt")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            stream = [json.loads(line) for line in f]
        saved = {n: _checksum(p) for n, p in small.optimizer.params.items()}
        saved_mu = {n: _checksum(t) for n, t in small.optimizer.mu.items()}
        timed_step(samples)                               # move on past the checkpoint
        moved_on = sum(_checksum(p) != saved[n] for n, p in small.optimizer.params.items())
        small.load_checkpoint(path)
        restored = (all(_checksum(p) == saved[n] for n, p in small.optimizer.params.items())
                    and all(_checksum(t) == saved_mu[n]
                            for n, t in small.optimizer.mu.items()))
        out_after, _, _ = timed_step(samples)
        rows.append(dict(
            phase="train", part="train_and_checkpoint", train_seconds=train_s,
            iters=2, metrics_lines=len(stream), losses=[m["loss"] for m in stream],
            launches=counts, file_gb=os.path.getsize(path) / 1e9, tensors=len(saved),
            tensors_moved_after_save=moved_on, restored_bit_identical=restored,
            step_restored=small.global_step - 1, start_epoch=small.start_epoch,
            loss_after_resume=out_after["loss"],
            ok=restored and moved_on > 0 and small.start_epoch == 1 and len(stream) == 2
            and finite(m["loss"] for m in stream) and small.optimizer.count == 3
            and small.global_step == 3 and counts == {k: 2 * n for k, n in want.items()}
            and finite([out_after["loss"]])))
        # every main-path launch of the train phase, by route
        rows.append(dict(phase="train", part="routes", launches=launches,
                         route_launches=routes,
                         ok=on_ruled_route(routes)
                         and all(sum(routes[n].values()) == launches[n] for n in ROUTED)))
    except BaseException:
        shutil.rmtree(out_dir, ignore_errors=True)
        raise
    finally:
        signal.signal(signal.SIGTERM, sigterm)            # train() installed its own
    for row in rows:
        row["nvidia_smi"] = smi
    cfg.model["with_sam"] = False      # spider_generate serves the tags it plants, not MASK
    return rows, launches, dict(cfg=cfg, checkpoint=path, out_dir=out_dir)


def phase_mask_step(dev, smi: str) -> dict:
    """The train phase's mask_step alone: the train entry's build_runner on
    train_config (the 8B Spider with SAM ViT-H), then mask_train_step."""
    import logging
    import shutil
    import tempfile

    from spider_tpu_torch import train as T

    out_dir = tempfile.mkdtemp(prefix="spider_mask_")
    try:
        runner = T.build_runner(train_config(out_dir), dev, "chip_smoke_mask")
        for handler in logging.getLogger().handlers:
            if getattr(handler, "stream", None) is sys.stdout:
                handler.setStream(sys.stderr)
        spider = runner.model
        L = spider.llm.config.num_hidden_layers
        want = dict(dict.fromkeys(KERNELS, 0), flash_fwd=L * (1 + spider.llm.config.remat),
                    flash_bwd_dq=L, flash_bwd_dkv=L)

        routes = {name: {} for name in ROUTED}

        def add(counts):
            """Add the launches just counted, by route, to `routes`."""
            for name, by_route in read_route_launches().items():
                for route, n in by_route.items():
                    routes[name][route] = routes[name].get(route, 0) + n

        def timed_step(samples):
            reset_launches()
            out, seconds = _sync_s(lambda: runner.train_step(samples))
            counts = read_launches()
            add(counts)
            return out, seconds, counts

        row = mask_train_step(runner, spider, want, timed_step, add)
        row.update(route_launches=routes, nvidia_smi=smi)
        row["ok"] = row["ok"] and on_ruled_route(routes)
        return row
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def train_mask_samples(seed: int, px: int):
    """A MASK batch of TRAIN_BATCH seeded samples: an image input for the
    encoder (ImageBind-huge's 224 px), its SAM input (`px`, padded) and a
    binary MASK_GT with one rectangle at the SAM size."""
    import numpy as np

    from spider_tpu_torch.processors.vision import image_to_imagebind, sam_preprocess

    rng = np.random.default_rng(seed)
    images, gts = [], []
    for _ in range(TRAIN_BATCH):
        images.append(rng.integers(0, 256, GROUNDING_HW + (3,), np.uint8))
        gt = np.zeros((px, px), np.float32)
        y0, x0 = rng.integers(px // 16, px // 2, 2)
        h, w = rng.integers(px // 10, px // 3, 2)
        gt[y0: y0 + h, x0: x0 + w] = 1.0
        gts.append(gt)
    B = TRAIN_BATCH
    return {"Question": ["segment the horse in <IMAGE><IMAGE-Placeholder></IMAGE>"] * B,
            "TaskPrompt": ["[MASK]"] * B,
            "Answer": ["<MASK>horse<MASK-Placeholder></MASK>"] * B,
            "IMAGE": [image_to_imagebind(im, TRAIN_IMAGE_SIZE) for im in images],
            "IMAGE_SAM": [sam_preprocess(im, px)[0] for im in images], "MASK": gts}


def mask_train_step(runner, spider, want: dict, timed_step, add) -> dict:
    """The train phase's part mask_step: three MASK steps through
    RunnerBase.train_step (s/step, peak GB, launches: the LLM's and the mask
    decoder's forward and backward flash calls, grounding_flash_calls of
    the MASK step's shapes), the mask decoder's gradients through the
    backward kernels against the plain backward (GRAD_REL, GRAD_COS), and
    SAM's image and prompt encoders bit-equal after the steps."""
    import torch

    from spider_tpu_torch.ops import attention as A

    sam = spider.sam
    samples = train_mask_samples(5, sam.config.img_size)
    n = grounding_flash_calls("sam_vit_h_mask_step")
    want_mask = dict(want, flash_fwd=want["flash_fwd"] + n,
                     flash_bwd_dq=want["flash_bwd_dq"] + n,
                     flash_bwd_dkv=want["flash_bwd_dkv"] + n)
    frozen = {k: _checksum(p) for k, p in sam.named_parameters()
              if not k.startswith("mask_decoder.")}
    decoder = {k: _checksum(p) for k, p in sam.mask_decoder.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    steps = [timed_step(samples) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() / 1e9

    def decoder_grads():
        spider.zero_grad(set_to_none=True)
        out = runner.loss_dict(samples)
        out["loss"].backward()
        # the iou head and the multimask hypernetworks get none (one mask out)
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                          .flatten() for p in sam.mask_decoder.parameters()])
        spider.zero_grad(set_to_none=True)
        return float(out["loss"].detach()), flat

    reset_launches()
    loss_k, g_k = decoder_grads()
    counts = read_launches()
    add(counts)
    kernel_backward = A.flash_backward
    A.flash_backward = (lambda q, k, v, out, lse, g, route=None, **kw:
                        A.flash_backward_reference(q, k, v, out, lse, g, **kw))
    try:
        reset_launches()
        loss_p, g_p = decoder_grads()
        plain_counts = read_launches()
    finally:
        A.flash_backward = kernel_backward
    rel = ((g_k - g_p).norm() / g_p.norm()).item()
    cos = torch.nn.functional.cosine_similarity(g_k, g_p, dim=0).item()
    moved = [k for k, p in sam.named_parameters()
             if not k.startswith("mask_decoder.") and _checksum(p) != frozen[k]]
    decoder_moved = sum(_checksum(p) != decoder[k]
                        for k, p in sam.mask_decoder.named_parameters())
    outs = [o for o, _, _ in steps]
    secs = [x for _, x, _ in steps]
    finite = all(v == v and abs(v) != float("inf") for o in outs for v in o.values())
    return dict(
        phase="train", part="mask_step", batch=TRAIN_BATCH, image_sam_px=sam.config.img_size,
        steps=3,
        s_per_step=statistics.median(secs), s_per_step_all=secs, peak_gb=peak,
        losses=[o["loss"] for o in outs], bce_loss=[o["bce_loss"] for o in outs],
        dice_loss=[o["dice_loss"] for o in outs], sam_flash_calls_per_step=n,
        launches_per_step=steps[-1][2], launches_expected=want_mask,
        grad_check=dict(loss_kernels=loss_k, loss_plain=loss_p, mask_decoder_grad_rel_diff=rel,
                        mask_decoder_grad_cosine=cos, grad_elements=g_p.numel(),
                        grad_norm=g_p.norm().item(), launches=counts,
                        launches_plain_route=plain_counts,
                        bounds=dict(rel=GRAD_REL, cosine=GRAD_COS)),
        sam_frozen_tensors=len(frozen), sam_frozen_moved=moved[:5],
        mask_decoder_tensors_moved=decoder_moved,
        ok=finite and all(c == want_mask for _, _, c in steps) and counts == want_mask
        and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and rel <= GRAD_REL and cos >= GRAD_COS
        and plain_counts["flash_bwd_dq"] == 0 and bool(torch.isfinite(g_k).all())
        and g_p.norm().item() > 0 and not moved and decoder_moved > 0)


class _RecordingPipe:
    """A pipeline passed through, recording the prompt embeddings each
    generation call gets."""

    def __init__(self, pipe):
        self.pipe, self.prompt_embeds = pipe, []

    def __call__(self, **kw):
        if kw.get("prompt_embeds") is not None:
            self.prompt_embeds.append(kw["prompt_embeds"])
        return self.pipe(**kw)


def phase_spider_generate(handoff: dict, sd, ad, vd, dev, smi: str):
    """Serve what the train phase trained: SpiderInference built from the
    train phase's config (preset 'full') on the card, its trainable
    parameters restored through load_demo_checkpoint from the checkpoint
    RunnerBase.train() wrote, the resident pipelines attached. One request
    with an image input (ImageBind-huge through encode_modalities, task
    [IMAGE], 64 new tokens) twice, and once with one new token (the
    prefill); then _decode_modality_infer for IMAGE, AUDIO and VIDEO on that
    run's hidden states, with each modality's signal tokens written into its
    token row (a random model never emits them)."""
    import gc

    import numpy as np
    import torch

    from spider_tpu_torch.models import spider as S
    from spider_tpu_torch.processors.vision import image_to_imagebind
    from spider_tpu_torch.serving.inference_api import SpiderInference

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    demo = os.path.join(handoff["out_dir"], "demo_config.json")
    with open(demo, "w") as f:
        json.dump({"type": "pt", "checkpoints": [handoff["checkpoint"]]}, f)
    t0 = time.perf_counter()
    inf = SpiderInference(handoff["cfg"], demo_config=demo, device=dev,
                          diffusion_pipes=dict(IMAGE=sd, AUDIO=ad, VIDEO=vd))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spider = inf.model
    saved = torch.load(handoff["checkpoint"], map_location=dev, weights_only=True)["params"]
    named = dict(spider.named_parameters())
    restored = all(torch.equal(named[n], t) for n, t in saved.items())
    n_saved = len(saved)
    del saved
    rows = [dict(phase="spider_generate", part="build", seconds=build_s,
                 restored_tensors=n_saved, restored_bit_equal=restored,
                 resident_before_gb=resident_gb, allocated_gb=torch.cuda.memory_allocated() / 1e9,
                 ok=bool(restored and spider.encoder is not None
                         and spider.moe_aligner is not None
                         and spider.llm.config.num_hidden_layers == 32))]

    rng = np.random.default_rng(21)
    image = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    samples = {"Question": ["What is in <IMAGE><IMAGE-Placeholder></IMAGE>? Draw it again."],
               "TaskPrompt": ["[IMAGE]"],
               "IMAGE": [image_to_imagebind(image, TRAIN_IMAGE_SIZE)]}
    runs = []
    decode = S.generate

    def recorded(model, embeds, prompt_len, cfg, generator=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(model, embeds, prompt_len, cfg, generator)
        torch.cuda.synchronize()
        runs[-1].update(decode_s=time.perf_counter() - t, T=embeds.shape[1],
                        prompt_len=int(prompt_len[0]), tokens=out["tokens"].cpu().numpy(),
                        step_hidden=out["step_hidden"])
        return out

    S.generate = recorded
    try:
        for new_tokens in (GENERATE_TOKENS, GENERATE_TOKENS, 1):
            runs.append({})
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers, preds, texts = inf(samples, max_new_tokens=new_tokens)
            torch.cuda.synchronize()
            runs[-1].update(seconds=time.perf_counter() - t0, answers=answers,
                            launches=read_launches(), routes=read_route_launches())
    finally:
        S.generate = decode
    a, b, prefill = runs
    L = spider.llm.config.num_hidden_layers
    same_bits = bool(np.array_equal(a["tokens"], b["tokens"])
                     and torch.equal(a["step_hidden"], b["step_hidden"])
                     and a["answers"] == b["answers"])
    for r in runs:
        r["flash_on_wgmma"] = (r["launches"]["flash_fwd"] == L
                               and r["routes"]["flash_fwd"]["wgmma"] == L
                               and on_ruled_route(r["routes"]))
    rows.append(dict(
        phase="spider_generate", part="generate", new_tokens=GENERATE_TOKENS,
        prompt_bucket=a["T"], prompt_len=a["prompt_len"], seconds=[a["seconds"], b["seconds"]],
        decode_s=[a["decode_s"], b["decode_s"]],
        prepare_and_encode_s=a["seconds"] - a["decode_s"],
        prefill_s=prefill["decode_s"], prefill_request_s=prefill["seconds"],
        decode_tok_s=(GENERATE_TOKENS - 1) / max(a["decode_s"] - prefill["decode_s"], 1e-9),
        tokens=int(a["tokens"].shape[1]), step_hidden=list(a["step_hidden"].shape),
        step_hidden_dtype=str(a["step_hidden"].dtype), answer_chars=len(a["answers"][0]),
        same_bits_twice=same_bits, launches=a["launches"], route_launches=a["routes"],
        ok=bool(same_bits and a["T"] % 32 == 0 and a["prompt_len"] < a["T"]
                and a["tokens"].shape == (1, GENERATE_TOKENS)
                and tuple(a["step_hidden"].shape) == (GENERATE_TOKENS - 1, 1, 1, 4096)
                and prefill["tokens"][0, 0] == a["tokens"][0, 0]
                and all(r["flash_on_wgmma"] for r in runs))))

    # the decoders, driven from the signal tokens' hidden states
    want = any_to_many_want(sd, ad, vd)
    launches = {name: sum(r["launches"][name] for r in runs) for name in KERNELS}
    at = 10                                       # where the signal run is written
    captions = {"IMAGE": SD_CAPTION, "AUDIO": AUDIO_CAPTION, "VIDEO": VIDEO_CAPTION}
    checks = dict(IMAGE=(lambda x: x.shape == (512, 512, 3) and x.min() >= 0 and x.max() <= 1,
                         {"flash_fwd": want["image_flash"]}),
                  AUDIO=(lambda x: list(x.shape) == want["audio_shape"][1:]
                         and x.min() >= -1 and x.max() <= 1, {"flash_fwd": want["audio_flash"]}),
                  VIDEO=(lambda x: list(x.shape) == want["video_shape"] and x.dtype == np.uint8,
                         {"flash_fwd": want["video_flash"], "tattn_fwd": want["video_tattn"]}))
    pipes = dict(spider.diffusion_pipes)
    try:
        for m, (media_ok, want_launches) in checks.items():
            tokens = a["tokens"].copy()
            sig = spider._signal_ids[m]
            tokens[0, at:at + len(sig)] = sig
            rec = _RecordingPipe(pipes[m])
            spider.diffusion_pipes[m] = rec
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = spider._decode_modality_infer(m, 0, captions[m], tokens, a["step_hidden"],
                                                samples, GUIDANCE, STEPS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got, routes = read_launches(), read_route_launches()
            for name in KERNELS:
                launches[name] += got[name]
            cond = rec.prompt_embeds[0] if rec.prompt_embeds else None
            cond_ok = (cond is not None and cond.dtype == torch.float32
                       and bool(torch.isfinite(cond).all())
                       and list(cond.shape) == ([1, 77, 768] if m == "IMAGE" else
                                                [1, 77, 1024] if m == "VIDEO" else [1, 512]))
            out = np.asarray(out)
            rows.append(dict(
                phase="spider_generate", part=f"decode_{m.lower()}", seconds=seconds,
                fused_shape=None if cond is None else list(cond.shape),
                fused_dtype=None if cond is None else str(cond.dtype), media_shape=list(out.shape),
                media_dtype=str(out.dtype),
                media_range=[float(out.min()), float(out.max())], launches=got,
                launches_expected=want_launches, route_launches=routes,
                ok=bool(cond_ok and media_ok(out) and on_ruled_route(routes)
                        and np.isfinite(out.astype(np.float32)).all()
                        and all(got[k] == v for k, v in want_launches.items()))))
    finally:
        spider.diffusion_pipes.update(pipes)
    rows.append(dict(phase="spider_generate", part="total",
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
                     ok=all(r["ok"] for r in rows)))
    for row in rows:
        row["nvidia_smi"] = smi
    del inf, spider, named, runs, a, b, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# train_data: train_configs/spider_train.py, the production recipe, at full
# width on real-format data (tar shards, a REFER corpus, a travel JSON, an
# HDF5 story file) written here by the port's own writers
# ---------------------------------------------------------------------------

TRAIN_DATA_CONFIG = "train_configs/spider_train.py"
TRAIN_DATA_SHARD_SAMPLES = 8          # samples a tar shard; two shards a family
TRAIN_DATA_SHUFFLE = 4                # the tar builders' shuffle buffer (the default 1000
                                      # would decode 1000 samples before the first)
TRAIN_DATA_EPOCH_ITERS = 16           # the short train_epoch at the config's ratios
TRAIN_DATA_PREFETCH = 6               # batches through PrefetchLoader and prepare_sample
DATA_IMAGE_HW = (384, 512)            # cc_sbu images and REFER images
DATA_VIDEO_FRAMES_HW = (24, 240, 320)  # webvid clips
DATA_AUDIO_SECONDS = 10.0             # audiocap clips at 16 kHz
DATA_REFER_IMAGES = 12
DATA_CAPTIONS = ("a dog running on the beach", "a red car parked near a tree",
                 "two children playing football", "a bowl of fruit on a table",
                 "a city street at night with lights", "a cat sleeping on a sofa",
                 "a mountain lake under a blue sky", "a man riding a bicycle")
TAR_FAMILIES = {
    "cc_sbu": ("i2t_cc_sbu", "t2i_cc_sbu", "t2i_ts_cc_sbu", "i2t_ts_cc_sbu"),
    "webvid": ("v2t_webvid", "t2v_webvid", "t2v_ts_webvid", "t2v_ts_mul_webvid",
               "t2v_ts_spec_webvid", "v2t_ts_webvid"),
    "audiocap": ("a2t_audiocap", "t2a_audiocap", "t2a_ts_audiocap", "a2t_ts_audiocap")}


def coco_rle_string(mask) -> str:
    """A binary mask's compressed COCO RLE string (pycocotools' rleToString:
    column-major runs, each from the run before last as a delta, in 5-bit
    groups with a continuation bit, offset by 48)."""
    import numpy as np

    flat = np.asarray(mask).T.reshape(-1)
    edges = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], edges, [flat.size]])
    runs = list(np.diff(bounds))
    if flat[0]:
        runs = [0] + runs                        # runs start with a run of zeros
    out = []
    for i, x in enumerate(int(r) for r in runs):
        if i > 2:
            x -= int(runs[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not c & 0x10 or x == -1 and c & 0x10)
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def write_train_data_sources(directory: str, seed: int) -> dict:
    """Real-format sources for spider_train.py's builders, written by the
    port's ShardWriter, flac and wav encoders: cc_sbu-, webvid- and
    audiocap-style tar shards; a REFER corpus (refcoco/refs(unc).p and
    instances.json, polygon and compressed-RLE annotations, its images); a
    travel-guide JSON; an HDF5 story file. Images are .jpg where PIL imports,
    videos .mp4 where cv2 can write one, the story HDF5 where h5py imports;
    else pre-decoded `<ext>.npy` members (or, for the story, the synthetic
    twin). Returns the paths and the formats used."""
    import io
    import pickle

    import numpy as np

    from spider_tpu_torch.datasets import media
    from spider_tpu_torch.datasets.flac import encode_flac
    from spider_tpu_torch.datasets.shard_writer import ShardWriter

    rng = np.random.default_rng(seed)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    try:
        import cv2
    except ImportError:
        cv2 = None
    try:
        import h5py
    except ImportError:
        h5py = None

    def picture(h, w):
        """Gradients with noise: compresses like a photo, unlike pure noise."""
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (h + w)], axis=-1)
        return np.clip(base + rng.integers(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)

    def jpeg(img) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    def mp4(frames):
        """mp4v bytes of `frames` through cv2, or None where it cannot write."""
        if cv2 is None:
            return None
        path = os.path.join(directory, "clip.mp4")
        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
        if not writer.isOpened():
            return None
        for f in frames:
            writer.write(f[..., ::-1].copy())
        writer.release()
        with open(path, "rb") as f:
            data = f.read()
        os.remove(path)
        return data

    n = 2 * TRAIN_DATA_SHARD_SAMPLES
    paths, formats = {}, {}
    pattern = os.path.join(directory, "{}-%03d.tar")
    with ShardWriter(pattern.format("cc_sbu"), TRAIN_DATA_SHARD_SAMPLES) as w:
        for i in range(n):
            img = picture(*DATA_IMAGE_HW)
            w.write(f"{i:06d}", {"jpg": jpeg(img) if Image else img,
                                 "txt": DATA_CAPTIONS[i % len(DATA_CAPTIONS)]})
    formats["cc_sbu"] = ["jpg" if Image else "jpg.npy", "txt"]
    T, H, W = DATA_VIDEO_FRAMES_HW
    video_formats = set()
    with ShardWriter(pattern.format("webvid"), TRAIN_DATA_SHARD_SAMPLES) as w:
        for i in range(n):
            frames = np.stack([np.roll(picture(H, W), 4 * t, axis=1) for t in range(T)])
            data = mp4(frames)
            video_formats.add("mp4" if data is not None else "mp4.npy")
            w.write(f"{i:06d}", {"mp4": data if data is not None else frames,
                                 "txt": DATA_CAPTIONS[(i + 3) % len(DATA_CAPTIONS)]})
    formats["webvid"] = sorted(video_formats) + ["txt"]
    t = np.arange(int(DATA_AUDIO_SECONDS * 16000)) / 16000
    with ShardWriter(pattern.format("audiocap"), TRAIN_DATA_SHARD_SAMPLES) as w:
        for i in range(n):
            wave = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                    + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
            audio = ({"flac": encode_flac(wave, 16000)} if i % 2 == 0
                     else {"wav": media.encode_wav_bytes(wave, 16000)})
            w.write(f"{i:06d}", {**audio, "txt": DATA_CAPTIONS[(i + 5) % len(DATA_CAPTIONS)]})
    formats["audiocap"] = ["flac (10 s, 16 kHz, encode_flac)", "wav (10 s, 16 kHz)", "txt"]
    for family in TAR_FAMILIES:
        paths[family] = os.path.join(directory, f"{family}-*.tar")

    # REFER: refs(unc).p + instances.json; even annotations polygons, odd ones
    # compressed RLE; images under images/ (COCO file names)
    refer_root = os.path.join(directory, "refer")
    image_dir = os.path.join(refer_root, "images")
    os.makedirs(os.path.join(refer_root, "refcoco"))
    os.makedirs(image_dir)
    h, w = DATA_IMAGE_HW
    images, anns, refs = [], [], []
    for i in range(DATA_REFER_IMAGES):
        name = f"COCO_train2014_{i:012d}.jpg"
        if Image is not None:
            Image.fromarray(picture(h, w)).save(os.path.join(image_dir, name), quality=90)
        images.append(dict(id=i, file_name=name, height=h, width=w))
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        bw, bh = int(rng.integers(w // 8, w // 2)), int(rng.integers(h // 8, h // 2))
        if i % 2 == 0:
            seg = [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh],
                   [x0 + bw / 2, y0 + bh, x0 + bw, y0 + 1.5 * bh, x0, y0 + 1.5 * bh]]
        else:
            mask = np.zeros((h, w), np.uint8)
            mask[y0: y0 + bh, x0: x0 + bw] = 1
            seg = dict(counts=coco_rle_string(mask), size=[h, w])
        anns.append(dict(id=100 + i, image_id=i, bbox=[x0, y0, bw, bh], segmentation=seg,
                         category_id=1))
        sentences = [dict(sent=DATA_CAPTIONS[i % len(DATA_CAPTIONS)])]
        if i % 3 == 0:
            sentences.append(dict(sent=f"the object on the {('left', 'right')[i % 2]}"))
        refs.append(dict(ref_id=i, ann_id=100 + i, image_id=i, category_id=1,
                         split="train" if i < DATA_REFER_IMAGES - 2 else "val",
                         sentences=sentences))
    with open(os.path.join(refer_root, "refcoco", "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(refer_root, "refcoco", "instances.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="object")]), f)
    paths.update(refer_root=refer_root, image_path=image_dir if Image else "")
    formats["refer"] = ["refs(unc).p", "instances.json (polygons, compressed RLE)",
                        "jpg" if Image else "no images: PIL does not import"]

    guides = [dict(location=f"City {i}", answer_multimodal=dict(
        introduction=f"City {i} sits on a river.",
        must_see_attractions=[f"Old gate<IMAGE>the old gate of city {i}</IMAGE>: stone.",
                              f"Harbour<VIDEO>boats in the harbour of city {i}</VIDEO>."],
        cultural_experiences=[f"Street music<AUDIO>street music of city {i}</AUDIO>."],
        food=f"Fish soup<IMAGE>a bowl of fish soup</IMAGE>: local.")) for i in range(12)]
    paths["travel_json"] = os.path.join(directory, "travel_guides.json")
    with open(paths["travel_json"], "w") as f:
        json.dump(guides, f)
    formats["travel_guide"] = ["json"]

    if h5py is not None:
        paths["story_hdf5"] = os.path.join(directory, "story.h5")
        with h5py.File(paths["story_hdf5"], "w") as f:
            f["image"] = np.stack([np.stack([picture(128, 128) for _ in range(5)])
                                   for _ in range(8)])
            f["text"] = np.array([[f"scene {j} of story {s}: {DATA_CAPTIONS[(s + j) % 8]}"
                                   for j in range(5)] for s in range(8)], dtype="S")
        formats["story"] = ["hdf5 (image [8, 5, 128, 128, 3], text [8, 5])"]
    else:
        formats["story"] = ["synthetic twin: h5py does not import"]
    return dict(paths=paths, formats=formats)


def train_data_config(out_dir: str, sources: dict):
    """train_configs/spider_train.py as `python -m spider_tpu_torch.train`
    reads it, set to the full preset with SAM ViT-H, every builder's tiny
    build_info replaced by the builders' own full-size defaults (224 px
    images, SAM at 1024, 128 mel bins x 204 frames, 5 clips) and the path of
    its source; batch sizes, ratios, length_bucket and max_context_len as
    the config gives them; the epoch cut to TRAIN_DATA_EPOCH_ITERS."""
    from spider_tpu_torch.common.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, TRAIN_DATA_CONFIG))
    cfg.model.preset = "full"
    cfg.model.with_sam = True
    paths = sources["paths"]
    for name, entry in cfg.datasets.items():
        family = next((f for f, names in TAR_FAMILIES.items() if name in names), None)
        if family is not None:
            info = dict(webdataset_path=paths[family], shuffle_buffer=TRAIN_DATA_SHUFFLE)
        elif "refcoco" in name:
            info = dict(refer_root=paths["refer_root"], image_path=paths["image_path"])
        elif name == "travel_guide":
            info = dict(json_path=paths["travel_json"])
        else:
            info = dict(hdf5_path=paths["story_hdf5"]) if "story_hdf5" in paths else {}
        entry.build_info = info
    cfg.run.output_dir = out_dir
    cfg.run.iters_per_epoch = TRAIN_DATA_EPOCH_ITERS
    cfg.run.log_freq = TRAIN_DATA_EPOCH_ITERS
    return cfg


def _same_tensors(got, want) -> bool:
    """Nested dicts and lists of tensors equal bit for bit, dtypes and devices
    included; other leaves equal."""
    import torch

    if isinstance(want, dict):
        return set(got) == set(want) and all(_same_tensors(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(_same_tensors(a, b) for a, b in zip(got, want))
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.device == want.device and torch.equal(got, want))
    if hasattr(want, "tolist"):                  # object arrays stay on the host
        return got.tolist() == want.tolist()
    return got == want


def phase_train_data(sd, ad, vd, dev, smi: str):
    """spider_train.py at full width through the train entry's build_runner
    and RunnerBase.train_step / train_epoch, on the sources of
    write_train_data_sources: one step from each of the 21 builders in the
    config's order, then a short train_epoch through MultiIterLoader at the
    config's ratios; PrefetchLoader against prepare_sample; one step under
    common/profiler.trace. Returns (rows, launches): the main path's launch
    counts are the 21 steps' and the epoch's."""
    import gc
    import logging
    import shutil
    import tempfile

    import torch

    from spider_tpu_torch import train as T
    from spider_tpu_torch.common import profiler
    from spider_tpu_torch.common.observability import HbmBudget
    from spider_tpu_torch.datasets import native_loader
    from spider_tpu_torch.datasets.utils.loaders import (MultiIterLoader, PrefetchLoader,
                                                          batched, prepare_sample)

    rows = []
    launches = dict.fromkeys(KERNELS, 0)
    routes = {name: dict.fromkeys(by_route, 0)
              for name, by_route in read_route_launches().items()}
    work = tempfile.mkdtemp(prefix="spider_train_data_")

    def add(counts):
        for name in KERNELS:
            launches[name] += counts[name]
        for name, by_route in read_route_launches().items():
            for route, n in by_route.items():
                routes[name][route] += n

    def finite(values):
        return all(v == v and abs(v) != float("inf") for v in values)

    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(work, "data"))
        sources = write_train_data_sources(os.path.join(work, "data"), seed=21)
        write_s = time.perf_counter() - t0
        rows.append(dict(phase="train_data", part="sources", seconds=write_s,
                         formats=sources["formats"], ok=True))

        t0 = time.perf_counter()
        cfg = train_data_config(os.path.join(work, "out"), sources)
        runner = T.build_runner(cfg, dev, "chip_smoke_data")
        for handler in logging.getLogger().handlers:
            if getattr(handler, "stream", None) is sys.stdout:
                handler.setStream(sys.stderr)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        spider = runner.model
        spider.diffusion_pipes.update(IMAGE=sd, VIDEO=vd, AUDIO=ad)
        llm_cfg = spider.llm.config
        L = llm_cfg.num_hidden_layers
        want = dict.fromkeys(KERNELS, 0)
        want.update(flash_fwd=L * (1 + llm_cfg.remat), flash_bwd_dq=L, flash_bwd_dkv=L)
        entries = runner.datasets["train"]
        budget = HbmBudget(dev)
        budget.register("llama3_8b (bf16 base, fp32 LoRA and vocabulary)", spider.llm)
        budget.register("imagebind_huge (bf16)", spider.encoder)
        budget.register("sam_vit_h (bf16, fp32 mask decoder)", spider.sam)
        budget.register("moe_aligner + llama_proj", [spider.moe_aligner, spider.llama_proj])
        budget.register("sd15 (bf16)", [sd.text_encoder, sd.unet, sd.vae])
        budget.register("zeroscope (bf16)", [vd.text_encoder, vd.unet, vd.vae])
        budget.register("audioldm (bf16)", [ad.text_encoder, ad.unet, ad.vae, ad.vocoder])
        rows.append(dict(
            phase="train_data", part="build", seconds=build_s, config=TRAIN_DATA_CONFIG,
            entry="spider_tpu_torch.train.build_runner",
            builders=list(entries), batch_sizes={n: e["batch_size"] for n, e in entries.items()},
            sample_ratios={n: e["sample_ratio"] for n, e in entries.items()},
            length_bucket=runner.length_bucket, max_context_len=spider.max_context_len,
            lora_r=llm_cfg.lora.r, layers=L, hidden=llm_cfg.hidden_size,
            sam_img_size=spider.sam.config.img_size if spider.sam is not None else None,
            ok=len(entries) == 21 and L == 32 and llm_cfg.hidden_size == 4096
            and llm_cfg.lora.r == 32 and spider.sam is not None
            and spider.max_context_len == cfg.model.max_context_len
            and runner.length_bucket == cfg.run.length_bucket))

        # ---- one step from each builder, in the config's order
        timer = profiler.StepTimer()
        torch.cuda.reset_peak_memory_stats()
        batches, steps_ok = {}, True
        for i, (name, entry) in enumerate(entries.items()):
            loader = batched(iter(entry["dataset"]), entry["batch_size"])
            t0 = time.perf_counter()
            samples = next(loader)
            data_s = time.perf_counter() - t0
            batches[name] = samples
            task = samples["TaskPrompt"][0]
            padded, live, _ = batch_tokens(spider, samples, runner.length_bucket)
            expect = dict(want)
            if task == "[MASK]" and spider.sam is not None:
                n = grounding_flash_calls("sam_vit_h_mask_step", len(samples["TaskPrompt"]))
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    expect[k] += n
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with timer.step():
                out = runner.train_step(samples)
                torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            counts, by_route = read_launches(), read_route_launches()
            add(counts)
            source = getattr(entry["dataset"], "source", None)
            row = dict(phase="train_data", part="builder_step", index=i, builder=name,
                       task=task, batch=len(samples["TaskPrompt"]), padded_tokens=padded,
                       live_tokens=live, step_s=step_s, data_s=data_s,
                       includes_warm_up=i == 0, losses=out, loss_finite=finite(out.values()),
                       launches=counts, launches_expected=expect,
                       route_launches={k: by_route[k] for k in ("flash_fwd", "flash_bwd_dq",
                                                                 "flash_bwd_dkv")},
                       tar_reader=getattr(source, "reader", None),
                       source=type(source).__name__ if source is not None else
                       type(entry["dataset"]).__name__)
            row["ok"] = (row["loss_finite"] and counts == expect
                         and on_ruled_route(by_route) and 0 < live <= padded)
            steps_ok &= row["ok"]
            rows.append(row)
        tar_readers = {n: getattr(entries[n]["dataset"].source, "reader", None)
                       for names in TAR_FAMILIES.values() for n in names}
        library = native_loader.LOADED_PATH
        rows.append(dict(
            phase="train_data", part="steps", builders=len(batches),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, step_timer=timer.summary(),
            hbm_budget=budget.report(log=lambda *a: None), tar_readers=tar_readers,
            native_library=os.path.relpath(library, ROOT) if library else None,
            data_s_total=sum(r["data_s"] for r in rows if r.get("part") == "builder_step"),
            step_s_total=sum(r["step_s"] for r in rows if r.get("part") == "builder_step"),
            ok=steps_ok and len(batches) == 21
            and all(r == "native" for r in tar_readers.values())
            and library is not None
            and os.path.dirname(library) == os.path.join(ROOT, "spider_tpu_torch", "build")))

        # ---- a short epoch through RunnerBase.train_epoch: MultiIterLoader
        # over the 21 builders at the config's ratios, the metrics stream
        reset_launches()
        step0 = runner.global_step
        epoch_s = _sync_s(lambda: runner.train_epoch(0))[1]
        counts = read_launches()
        add(counts)
        with open(os.path.join(cfg.run.output_dir, "metrics.jsonl")) as f:
            stream = [json.loads(line) for line in f]
        n = TRAIN_DATA_EPOCH_ITERS
        mask_steps = (counts["flash_fwd"] - n * want["flash_fwd"]) / max(
            grounding_flash_calls("sam_vit_h_mask_step", 1), 1)
        rows.append(dict(
            phase="train_data", part="train_epoch", iters=n, seconds=epoch_s,
            s_per_iter=epoch_s / n, losses=[m["loss"] for m in stream], launches=counts,
            mask_steps_by_launches=mask_steps,
            ok=runner.global_step == step0 + n and len(stream) == n
            and finite(m["loss"] for m in stream)
            and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"]
            and counts["flash_bwd_dq"] - n * want["flash_bwd_dq"]
            == counts["flash_fwd"] - n * want["flash_fwd"]
            and mask_steps == int(mask_steps) >= 0))

        # ---- PrefetchLoader: the same bits as prepare_sample; data seconds the
        # consumer waits with and without it, a consumer taking one median
        # step's time (host sleep) between batches
        fixed = [batches[name] for name in list(entries)[:TRAIN_DATA_PREFETCH]]
        got = list(PrefetchLoader(iter(fixed), 2, dev))
        same = all(_same_tensors(g, prepare_sample(b, dev)) for g, b in zip(got, fixed))
        del got
        step_s = statistics.median(r["step_s"] for r in rows if r.get("part") == "builder_step")

        def mixed():
            iters = [batched(iter(e["dataset"]), e["batch_size"]) for e in entries.values()]
            return MultiIterLoader(iters, [e["sample_ratio"] for e in entries.values()],
                                   seed=7)

        def waits(it):
            total = 0.0
            for _ in range(TRAIN_DATA_PREFETCH):
                t0 = time.perf_counter()
                batch = next(it)
                torch.cuda.synchronize()
                total += time.perf_counter() - t0
                del batch
                time.sleep(step_s)
            return total

        plain_wait = waits(prepare_sample(b, dev) for b in mixed())
        prefetch_it = iter(PrefetchLoader(mixed(), 2, dev))
        prefetch_wait = waits(prefetch_it)
        prefetch_it.close()
        rows.append(dict(phase="train_data", part="prefetch", batches=len(fixed),
                         same_bits=same, consumer_step_s=step_s, draws=TRAIN_DATA_PREFETCH,
                         data_wait_s_prepare_sample=plain_wait,
                         data_wait_s_prefetch_loader=prefetch_wait, depth=2,
                         ok=same and len(fixed) == TRAIN_DATA_PREFETCH))

        # ---- common/profiler.trace around one step: the device rows name the
        # three kernels (these launches are not counted)
        samples = batches["i2t_cc_sbu"]
        with profiler.trace(os.path.join(work, "trace")) as prof, profiler.recording():
            with profiler.span("train_data::step"):
                runner.train_step(samples)
            torch.cuda.synchronize()
        profiler.drain()
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in name for name in kernels)
                 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        rows.append(dict(phase="train_data", part="profile_trace",
                         trace_mb=os.path.getsize(prof.trace_path) / 1e6,
                         device_rows=len(kernels), kernel_rows=named,
                         annotated=any(e.get("name") == "train_data::step" for e in events),
                         ok=all(v > 0 for v in named.values())))
        rows.append(dict(phase="train_data", part="routes", launches=launches,
                         route_launches=routes,
                         ok=on_ruled_route(routes)
                         and all(sum(routes[n].values()) == launches[n] for n in ROUTED)))
        del runner, spider, batches, fixed, samples
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    for row in rows:
        row["nvidia_smi"] = smi
    return rows, launches


# ---------------------------------------------------------------------------
# checkpoint: synthetic HF/diffusers checkpoints written at full size, loaded
# through the port's own entry points
# ---------------------------------------------------------------------------

class HostRssPeak:
    """Peak resident set size of this process while the block runs, sampled
    from /proc/self/statm every millisecond by a thread (VmHWM covers the
    whole life of the process, and a process may not be allowed to reset it
    through /proc/self/clear_refs)."""

    def __init__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.base = self.peak = self._rss()

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.001):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())

    def row(self) -> dict:
        return dict(host_rss_gb_before=self.base / 1e9, host_rss_gb_peak=self.peak / 1e9,
                    host_rss_gb_added=(self.peak - self.base) / 1e9)


def manifest_keys(name: str):
    with open(os.path.join(ROOT, "tests", "fixtures", "convert_keys", f"{name}.txt")) as f:
        return [line for line in f.read().splitlines() if line]


def fill_synthetic_(module, seed: int):
    """Every floating tensor of `module` ~ N(0, 0.02), norm scales 1 +
    N(0, 0.02) (a seeded generator on the module's device), so no two
    tensors of a checkpoint are alike."""
    import torch
    from torch import nn

    gen = None
    with torch.no_grad():
        for mname, mod in module.named_modules():
            norm = isinstance(mod, (nn.LayerNorm, nn.GroupNorm))
            for pname, t in list(mod.named_parameters(recurse=False)) + list(
                    mod.named_buffers(recurse=False)):
                if not t.is_floating_point():
                    continue
                if gen is None:
                    gen = torch.Generator(device=t.device).manual_seed(seed)
                t.normal_(0.0, 0.02, generator=gen)
                if (norm and pname == "weight") or pname.endswith("layernorm") or \
                        (pname == "norm" and mname == "model"):
                    t.add_(1.0)
    return module


def _states_equal(loaded, want) -> list:
    """Names where `loaded`'s tensor differs from `want`'s (cast to
    `loaded`'s dtype) or does not lie on the card."""
    bad = []
    for name, t in loaded.items():
        w = want[name].to(t.device, t.dtype)
        if t.device.type != "cuda" or t.shape != w.shape or not bool((t == w).all()):
            bad.append(name)
    return sorted(bad) + sorted(set(want) - set(loaded))


def _timed_load(fn):
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with HostRssPeak() as rss:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, dict(load_s=seconds, device_gb=(torch.cuda.memory_allocated() - before) / 1e9,
                     **rss.row())


def write_llama_checkpoint(directory: str, dev):
    """The synthetic Llama-3-8B in Meta's HF layout: llama3_8b's width,
    depth and vocabulary in bf16, CKPT_SHARDS safetensors shards of about
    equal size plus the index and config.json. Cuts the depth, never the
    width or vocabulary, if the disk cannot hold it. Returns (source model
    in bf16 on the card, {checkpoint key: tensor on the card}, row)."""
    import dataclasses
    import shutil

    import torch

    from spider_tpu_torch.models import checkpoint_io as io
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import llama as L

    full = dataclasses.replace(L.llama3_8b(), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    H, V, I = full.hidden_size, full.vocab_size, full.intermediate_size
    kv = full.num_key_value_heads * full.head_dim_
    per_layer = 2 * (2 * H * H + 2 * kv * H + 3 * H * I + 2 * H)
    fixed = 2 * (2 * V * H + H)
    free = shutil.disk_usage(directory).free
    depth = full.num_hidden_layers
    if fixed + depth * per_layer > 0.9 * free:
        depth = int((0.9 * free - fixed) // per_layer)
        if depth < 1:
            raise RuntimeError(f"{free / 1e9:.1f} GB free cannot hold even one layer")
    cfg = dataclasses.replace(full, num_hidden_layers=depth)
    t0 = time.perf_counter()
    src = fill_synthetic_(L.LlamaForCausalLM(cfg, dev).eval(), CKPT_SEED)
    rules = C.llama_rules({"lm_head.weight"}, cfg)
    hf = C.export_state_dict(rules, src.state_dict())
    order = [k for r in rules for k in r.keys]            # embed, layers, norm, lm_head
    total = sum(t.numel() * t.element_size() for t in hf.values())
    shards, cur, size = [], [], 0
    for k in order:
        cur.append(k)
        size += hf[k].numel() * hf[k].element_size()
        if size >= total * (len(shards) + 1) / CKPT_SHARDS and len(shards) < CKPT_SHARDS - 1:
            shards.append(cur)
            cur = []
    shards.append(cur)
    io.save_sharded([lambda keys=keys: {k: hf[k].cpu() for k in keys} for keys in shards],
                    directory)
    rope = dict(cfg.rope_scaling, rope_type="llama3")
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dict(architectures=["LlamaForCausalLM"], model_type="llama",
                       vocab_size=V, hidden_size=H, intermediate_size=I,
                       num_hidden_layers=depth, num_attention_heads=cfg.num_attention_heads,
                       num_key_value_heads=cfg.num_key_value_heads,
                       max_position_embeddings=cfg.max_position_embeddings,
                       rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                       rope_scaling=rope, tie_word_embeddings=False, attention_bias=False,
                       hidden_act="silu", torch_dtype="bfloat16"), f, indent=2)
    files = sorted(os.listdir(directory))
    want_keys = manifest_keys("llama3_8b")
    if depth < full.num_hidden_layers:
        want_keys = [k for k in want_keys
                     if not k.startswith("model.layers.") or int(k.split(".")[2]) < depth]
    return src, hf, dict(
        depth=depth, depth_cut=depth < full.num_hidden_layers, free_disk_gb=free / 1e9,
        checkpoint_gb=total / 1e9, shards=len(shards), files=files,
        keys_equal_manifest=sorted(hf) == sorted(want_keys), write_s=time.perf_counter() - t0)


def _greedy(model, ids, n):
    import torch

    from spider_tpu_torch.models.decode import GenerateConfig, generate

    with torch.inference_mode():
        out = generate(model, model.embed(ids), torch.tensor([ids.shape[1]], dtype=torch.int32),
                       GenerateConfig(max_new_tokens=n))
    return out["tokens"][0].tolist()


def checkpoint_llama(directory: str, dev):
    """Write the synthetic 8B, load it with from_pretrained('llama',
    path=...), hold every tensor to the on-card conversion of the written
    tensors, and decode: a T 128 prefill and CKPT_NEW_TOKENS greedy tokens
    against a model filled in memory from the same tensors."""
    import dataclasses

    import torch

    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    src, hf, row = write_llama_checkpoint(directory, dev)
    (model, tokenizer), load = _timed_load(
        lambda: factory.from_pretrained("llama", path=directory, device=dev))
    cfg8 = dataclasses.replace(src.config, quantization="int8")
    ref = L.LlamaForCausalLM(cfg8, dev).eval()
    ref.load_state_dict(C.convert_llama_state_dict(hf, cfg8, "int8"), strict=True)
    bad = _states_equal(model.state_dict(), ref.state_dict())
    q, scale = C.quantize_int8(hf["model.layers.0.mlp.down_proj.weight"])
    down = model.model.layers[0].mlp.down_proj
    same_cfg = all(getattr(model.config, f) == getattr(src.config, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "rope_theta", "rope_scaling"))

    prompt = CHAT_PROMPT
    ids = torch.tensor([tokenizer(prompt).input_ids], dtype=torch.long, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    got = _greedy(model, ids, CKPT_NEW_TOKENS)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches, routes = read_launches(), read_route_launches()
    want = _greedy(ref, ids, CKPT_NEW_TOKENS)
    chat = make_llama_chat_fn(model, tokenizer, max_new_tokens=CKPT_NEW_TOKENS)(prompt)
    ref_chat = make_llama_chat_fn(ref, tokenizer, max_new_tokens=CKPT_NEW_TOKENS)(prompt)
    gb = row["checkpoint_gb"]
    row = dict(phase="checkpoint", model="llama", **row)
    row.update(load, read_gb_per_s=gb / load["load_s"],
               tokenizer=type(tokenizer).__name__, prompt_tokens=ids.shape[1],
               tensors=len(ref.state_dict()), tensors_differing=bad[:8],
               quantize_direct_equal=bool(torch.equal(q, down.kernel_q)
                                          and torch.equal(scale, down.kernel_scale)),
               config_equal=same_cfg, new_tokens=len(got), tokens_equal=got == want,
               chat_equal=chat == ref_chat, generate_s=decode_s, launches=launches,
               route_launches=routes)
    row["ok"] = bool(row["keys_equal_manifest"] and not bad and ids.shape[1] == PROMPT_TOKENS and row["quantize_direct_equal"]
                     and same_cfg and got == want and len(got) == CKPT_NEW_TOKENS
                     and chat == ref_chat and launches["flash_fwd"] == src.config.num_hidden_layers
                     and routes["flash_fwd"]["wgmma"] == src.config.num_hidden_layers
                     and on_ruled_route(routes))
    del model, ref
    torch.cuda.empty_cache()
    return src, hf, row


# The manifests of each pipeline's subfolders. AudioLDM's UNet also reads the
# four class-embedding keys the pipeline's UNet has (the manifest's config has
# no class embedding), and its vocoder is written weight-normed: each conv's
# `weight` of the manifest as `weight_g` and `weight_v`.
PIPELINE_MANIFESTS = {
    "sd15": {"text_encoder": "clip_vit_l14", "unet": "unet_sd15", "vae": "vae_sd"},
    "zeroscope": {"text_encoder": "clip_vit_h14", "unet": "unet3d_zeroscope", "vae": "vae_sd"},
    "audioldm": {"text_encoder": "clap_text", "unet": "unet_audioldm", "vae": "vae_audioldm",
                 "vocoder": "hifigan_audioldm"},
}
CLASS_EMBED_KEYS = [f"class_embedding.linear_{i}.{p}" for i in (1, 2) for p in ("weight", "bias")]


def _checkpoint_keys(kind: str, sub: str):
    keys = manifest_keys(PIPELINE_MANIFESTS[kind][sub])
    if kind == "audioldm" and sub == "unet":
        keys += CLASS_EMBED_KEYS
    if sub == "vocoder":
        keys = [k[:-7] + s if k.endswith(".weight") else k for k in keys
                for s in ((".weight_g", ".weight_v") if k.endswith(".weight") else ("",))]
    return keys


def checkpoint_pipeline(kind: str, directory: str, dev):
    """Write a diffusers-layout synthetic checkpoint of `kind` at full size
    (fp16, as the releases' fp16 variants; the vocoder fp32 as a .bin), load
    it with from_pretrained(kind, path=...) in bf16 and hold every tensor to
    the written one; for sd15 one CFG UNet call at 512px against the
    pipeline filled in memory from the same tensors."""
    import torch

    from spider_tpu_torch.models import checkpoint_io as io
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory

    t0 = time.perf_counter()
    written, keys_ok, total = {}, True, 0
    for i, (sub, (module, rules_fn)) in enumerate(
            factory.pipeline_parts(kind, device=dev, dtype=torch.float16).items()):
        keys = _checkpoint_keys(kind, sub)
        rules = rules_fn(keys, module.config)
        hf = C.export_state_dict(rules, fill_synthetic_(module, CKPT_SEED + i).state_dict())
        keys_ok &= sorted(hf) == sorted(keys)
        os.makedirs(os.path.join(directory, sub))
        cpu = {k: v.cpu() for k, v in hf.items()}
        if sub == "vocoder":
            torch.save(cpu, os.path.join(directory, sub, "pytorch_model.bin"))
        else:
            io.save_file(cpu, os.path.join(directory, sub, "diffusion_pytorch_model.safetensors"))
        total += sum(t.numel() * t.element_size() for t in cpu.values())
        written[sub] = (rules, hf)
        del module, cpu
    write_s = time.perf_counter() - t0
    pipe, load = _timed_load(lambda: factory.from_pretrained(kind, path=directory, device=dev,
                                                             dtype=torch.bfloat16))
    bad = []
    for sub, (rules, hf) in written.items():
        bad += [f"{sub}.{n}" for n in _states_equal(getattr(pipe, sub).state_dict(),
                                                    C.convert_state_dict(rules, hf))]
    row = dict(phase="checkpoint", model=kind, checkpoint_gb=total / 1e9, write_s=write_s,
               read_gb_per_s=total / 1e9 / load["load_s"], keys_equal_manifest=keys_ok,
               tensors_differing=bad[:8], **load)
    row["ok"] = keys_ok and not bad
    if kind == "sd15":
        parts = factory.pipeline_parts(kind, device=dev, dtype=torch.bfloat16)
        unet = parts["unet"][0].eval()
        unet.load_state_dict(C.convert_state_dict(*written["unet"]), strict=True)
        gen = torch.Generator(device=dev).manual_seed(3)
        ucfg = unet.config                           # 512px: a 64x64 latent, 77 tokens
        x = torch.randn(1, 64, 64, ucfg.in_channels, generator=gen, device=dev)
        ctx = torch.randn(2, 77, ucfg.cross_attention_dim, generator=gen, device=dev)
        x, ctx = x.to(torch.bfloat16), ctx.to(torch.bfloat16)
        t = torch.tensor([981, 981], device=dev)
        with torch.inference_mode():
            got = pipe.unet(torch.cat([x, x]), t, ctx)
            want = unet(torch.cat([x, x]), t, ctx)
        row.update(unet_call_bits_equal=bool(torch.equal(got, want)),
                   unet_out_finite=bool(torch.isfinite(got).all()),
                   unet_out_shape=list(got.shape))
        row["ok"] &= row["unet_call_bits_equal"] and row["unet_out_finite"]
        del parts, unet
    del pipe, written
    torch.cuda.empty_cache()
    return row


def checkpoint_imagebind(directory: str, dev):
    """ImageBind-huge (vision and audio trunks, the manifest's keys) as one
    fp32 .pth, as that release ships, loaded with
    from_pretrained('imagebind', path=...)."""
    import dataclasses

    import torch

    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models.imagebind import ImageBindEncoder, imagebind_huge

    t0 = time.perf_counter()
    module = ImageBindEncoder(dataclasses.replace(imagebind_huge(), dtype=torch.float32), dev)
    keys = manifest_keys("imagebind_huge")
    rules = C.imagebind_rules(keys, module.config)
    hf = C.export_state_dict(rules, fill_synthetic_(module, CKPT_SEED).state_dict())
    path = os.path.join(directory, "imagebind_huge.pth")
    cpu = {k: v.cpu() for k, v in hf.items()}
    torch.save(cpu, path)
    total = sum(t.numel() * t.element_size() for t in cpu.values())
    del module, cpu
    write_s = time.perf_counter() - t0
    enc, load = _timed_load(lambda: factory.from_pretrained("imagebind", path=path, device=dev,
                                                            dtype=torch.bfloat16))
    bad = _states_equal(enc.state_dict(), C.convert_state_dict(rules, hf))
    row = dict(phase="checkpoint", model="imagebind", checkpoint_gb=total / 1e9,
               write_s=write_s, read_gb_per_s=total / 1e9 / load["load_s"],
               keys_equal_manifest=sorted(hf) == sorted(keys), tensors_differing=bad[:8], **load)
    row["ok"] = row["keys_equal_manifest"] and not bad
    del enc, hf
    torch.cuda.empty_cache()
    return row


def checkpoint_spider(directory: str, dev, src, hf):
    """build_full_spider(paths={'llama': directory}): the base leaves are
    the checkpoint's bits, the rows past its vocabulary the reference's
    extension rows, and what trains is what the random-init build trains."""
    import torch

    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory

    spider, load = _timed_load(lambda: factory.build_full_spider(
        device=dev, paths={"llama": directory}, with_sam=False))
    llm, V = spider.llm, src.config.vocab_size
    new_vocab = llm.config.vocab_size
    state = llm.state_dict()
    bad = []
    for rule in C.llama_rules(hf, src.config):
        name, key = rule.names[0], rule.keys[0]
        got = state[name][:V] if name in ("embed_tokens.weight", "lm_head.weight") else state[name]
        if not torch.equal(got, hf[key].to(got.dtype)):
            bad.append(name)
    ext = C.extend_llama_embeddings({"embed_tokens.weight": hf["model.embed_tokens.weight"],
                                     "lm_head.weight": hf["lm_head.weight"]}, new_vocab)
    rows_equal = all(torch.equal(state[n][V:], ext[n][V:]) for n in ext)
    trainable = {n for n, p in llm.named_parameters() if p.requires_grad}
    lora = {n for n in state if n.endswith(("lora_a", "lora_b"))}
    frozen_ok = (trainable == lora | {"embed_tokens.weight", "lm_head.weight"}
                 and llm.embed_tokens.weight.dtype == torch.float32
                 and llm.model.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
                 and V == FROZEN_ROWS)
    row = dict(phase="checkpoint", model="build_full_spider", vocab=new_vocab, base_vocab=V,
               new_rows=new_vocab - V, base_tensors_differing=bad[:8],
               extension_rows_equal=rows_equal, trainable_as_random_build=frozen_ok,
               tokenizer=type(spider.tokenizer).__name__, **load)
    row["ok"] = not bad and rows_equal and frozen_ok and new_vocab > V
    del spider, llm, state
    torch.cuda.empty_cache()
    return row


R1_PROMPT = "Hello, who are you?"    # the infer twin's default question
R1_GRADIO_TOKENS = 32


def checkpoint_r1_twins(directory: str, dev, src, hf):
    """The r1_llama3_8B twins on the synthetic 8B directory through
    SPIDER_TPU_LLM_CKPT. The infer twin's build_r1 loads it unquantised (fp32
    parameters, bf16 arithmetic), as the reference's serving loader does: its
    reply must equal make_llama_chat_fn's on a model filled in memory from
    the same tensors, and so must the tokens behind it (TinyTokenizer decodes
    most of the 8B's ids to nothing). The gradio twin's server stack
    (speculative chat, no decoders) answers one POST /chat. Returns (row,
    the launches of the twin's reply)."""
    import dataclasses
    import gc
    import http.client

    import torch

    from spider_tpu_torch import r1_llama3_8B_gradio, r1_llama3_8B_infer
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import decode
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.tokenizer import TinyTokenizer
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    tokens = []
    generate = decode.generate

    def recorded(*args, **kw):
        out = generate(*args, **kw)
        tokens.append(out["tokens"][0].tolist())
        return out

    before = os.environ.get("SPIDER_TPU_LLM_CKPT")
    os.environ["SPIDER_TPU_LLM_CKPT"] = directory
    decode.generate = recorded
    try:
        t0 = time.perf_counter()
        chat = r1_llama3_8B_infer.build_r1(device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        reply = chat(R1_PROMPT)
        torch.cuda.synchronize()
        reply_s = time.perf_counter() - t0
        launches, routes = read_launches(), read_route_launches()
        del chat
        free()
        cfg = dataclasses.replace(src.config, param_dtype=torch.float32)
        ref = L.LlamaForCausalLM(cfg, dev).eval()
        ref.load_state_dict(C.convert_llama_state_dict(hf, cfg), strict=True)
        want = make_llama_chat_fn(ref, TinyTokenizer(), max_new_tokens=64)(R1_PROMPT)
        del ref
        free()

        t0 = time.perf_counter()
        server = r1_llama3_8B_gradio.main(
            ["--port", "0", "--max-new-tokens", str(R1_GRADIO_TOKENS)], background=True)
        boot_s = time.perf_counter() - t0
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=600)
            t0 = time.perf_counter()
            conn.request("POST", "/chat", json.dumps({"text": R1_PROMPT}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            post_s = time.perf_counter() - t0
            conn.close()
        finally:
            server.shutdown()
            server.server_close()
        del server
        free()
    finally:
        decode.generate = generate
        if before is None:
            os.environ.pop("SPIDER_TPU_LLM_CKPT", None)
        else:
            os.environ["SPIDER_TPU_LLM_CKPT"] = before
    layers = src.config.num_hidden_layers
    twin_tokens, want_tokens = tokens[:2]
    row = dict(phase="checkpoint", model="r1_twins", infer_load_s=load_s, infer_reply_s=reply_s,
               infer_reply_chars=len(reply), infer_equal_in_memory=reply == want,
               infer_tokens=len(twin_tokens), infer_tokens_equal=twin_tokens == want_tokens,
               gradio_boot_s=boot_s, gradio_post_s=post_s, gradio_status=resp.status,
               gradio_answer_chars=len(out.get("answer", "")), gradio_events=out.get("events"),
               launches=launches, route_launches=routes)
    row["ok"] = bool(reply == want and twin_tokens == want_tokens and len(tokens) == 2
                     and len(twin_tokens) == 64 and resp.status == 200
                     and isinstance(out.get("answer"), str) and out.get("events") == []
                     and launches["flash_fwd"] == layers and routes["flash_fwd"]["wgmma"] == layers
                     and on_ruled_route(routes))
    return row, launches


def phase_checkpoint(dev, smi: str):
    """The checkpoint slice: the rows above, each emitted when done, each
    family written, loaded, checked and deleted before the next; the 8B
    checkpoint stays on disk for build_full_spider, last. Returns (all rows
    ok, the launches of the 8B prefill and decode: the slice's main path)."""
    import shutil
    import tempfile

    import torch

    ok = True
    root = tempfile.mkdtemp(prefix="spider_ckpt_")
    t_phase = time.perf_counter()

    def done(row):
        nonlocal ok
        emit(dict(row, nvidia_smi=smi))
        ok &= row["ok"]

    try:
        done(dict(phase="checkpoint", model="disk", ok=True,
                  directory_free_gb=shutil.disk_usage(root).free / 1e9))
        llama_dir = os.path.join(root, "llama")
        os.makedirs(llama_dir)
        src, hf, row = checkpoint_llama(llama_dir, dev)
        done(row)
        for kind in ("sd15", "zeroscope", "audioldm"):
            d = os.path.join(root, kind)
            done(checkpoint_pipeline(kind, d, dev))
            shutil.rmtree(d)
        d = os.path.join(root, "imagebind")
        os.makedirs(d)
        done(checkpoint_imagebind(d, dev))
        for grounding_row in checkpoint_grounding(d, dev):
            done(grounding_row)
        shutil.rmtree(d)
        done(checkpoint_spider(llama_dir, dev, src, hf))
        twins, twin_launches = checkpoint_r1_twins(llama_dir, dev, src, hf)
        done(twins)
        del src, hf
        torch.cuda.empty_cache()
        shutil.rmtree(llama_dir)
        d = os.path.join(root, "qwen2_5_omni")
        os.makedirs(d)
        omni_launches = dict.fromkeys(KERNELS, 0)
        for omni_row in checkpoint_omni(d, dev):
            done(omni_row)
            if "launches" in omni_row:
                _add_launches(omni_launches, omni_row["launches"])
        shutil.rmtree(d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    done(dict(phase="checkpoint", model="total", seconds=time.perf_counter() - t_phase, ok=ok))
    return ok, _add_launches(_add_launches(dict(row["launches"]), twin_launches),
                             omni_launches)


# ---------------------------------------------------------------------------
# The rest of the Llama family on the main path: prompt-lookup speculation,
# token streaming and the wave batcher on the 8B chat model; Qwen2-7B and
# Llama-2-7B at full width and depth; the MoE FFN at llama3_8b width
# ---------------------------------------------------------------------------

SPEC_PROMPT_TOKENS = 128              # bench_suite.py::bench_speculative_decode's point
SPEC_NEW_TOKENS = 128
SPEC_GAMMA = 8
SPEC_MAX_NGRAM = 3
FAMILY_NEW_TOKENS = 32
MROPE_SECTION = (16, 24, 24)          # Qwen2-VL's split of head_dim/2 = 64
BATCHER_REQUESTS = 8
BATCHER_SINGLE = 4                    # of them also decoded alone, for the agreement share
QWEN2_PAGED_REQUESTS = 4
QWEN2_CKPT_LAYERS = 4                 # the synthetic Qwen2 checkpoint's depth (of 28)
MOE_LAYERS = 2                        # of llama3_8b's 32: 60 GB of experts at full depth
MOE_EXPERTS = 4
MOE_PROMPT_TOKENS = 128
# Two routes whose logits differ by at most LOGIT_ATOL (the in-model bound of
# paged_check and int4_check) can pick different argmaxes only where the top
# two logits are within twice that.
FLIP_GAP = 2 * LOGIT_ATOL


def _sync_s(fn):
    """(fn(), host seconds to a device synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _add_launches(total: dict, counts: dict) -> dict:
    for name in KERNELS:
        total[name] = total.get(name, 0) + counts[name]
    return total


def _first_divergence(a, b):
    """Index of the first position where token lists a and b differ (the
    shorter length if one is a prefix of the other), and whether they are
    equal."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n, list(a) == list(b)


def _stepped_gap(model, ids, tokens, i, max_len):
    """Top-2 logit gap of the stepped greedy decode (decode.generate's
    prefill and single-token steps over a cache of max_len) at the step that
    chose tokens[i]."""
    import torch

    from spider_tpu_torch.models.llama import init_kv_cache

    dev = model.device
    T = len(ids)
    cache = init_kv_cache(model.config, 1, max_len, device=dev)
    kv = torch.tensor([T], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits, _, cache = model(input_ids=torch.tensor([ids], device=dev), kv_write_index=0,
                                 kv_cache=cache, kv_len=kv)
        for t in tokens[:i]:
            logits, _, cache = model(input_ids=torch.tensor([[t]], device=dev),
                                     positions=kv[:, None], kv_write_index=kv, kv_cache=cache,
                                     kv_len=kv + 1)
            kv = kv + 1
        top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def _greedy_by_positions(model, ids, n, streams: bool):
    """decode.generate's greedy stream with explicit positions: [B, T] as
    generate gives them, or the same positions on the three mrope streams
    [3, B, T] (text tokens)."""
    import torch

    from spider_tpu_torch.models.llama import init_kv_cache

    dev = model.device
    T = len(ids)
    cache = init_kv_cache(model.config, 1, T + n, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    kv = torch.tensor([T], dtype=torch.int32, device=dev)
    lift = (lambda p: p[None].expand(3, *p.shape)) if streams else (lambda p: p)
    with torch.inference_mode():
        logits, _, cache = model(input_ids=torch.tensor([ids], device=dev), positions=lift(pos),
                                 kv_write_index=0, kv_cache=cache, kv_len=kv)
        tok = logits[:, -1].argmax(-1)
        out = [tok]
        for _ in range(n - 1):
            logits, _, cache = model(input_ids=tok[:, None], positions=lift(kv[:, None]),
                                     kv_write_index=kv, kv_cache=cache, kv_len=kv + 1)
            tok = logits[:, -1].argmax(-1)
            out.append(tok)
            kv = kv + 1
    return torch.cat(out).tolist()


def _generate_ids(model, ids, n, eos=(), pad=0):
    """decode.generate's tokens of one prompt at batch 1, and its seconds."""
    import torch

    from spider_tpu_torch.models.decode import GenerateConfig, generate

    with torch.inference_mode():
        emb = model.embed(torch.tensor([ids], device=model.device))
    out, s = _sync_s(lambda: generate(model, emb, torch.tensor([len(ids)], dtype=torch.int32),
                                      GenerateConfig(max_new_tokens=n, eos_ids=tuple(eos),
                                                     pad_id=pad)))
    return out["tokens"][0].tolist(), s


def _flash_on_wgmma(launches, routes, want: int) -> bool:
    return (launches["flash_fwd"] == want and routes["flash_fwd"]["wgmma"] == want
            and on_ruled_route(routes))


def phase_speculative(model, tokenizer, smi: str):
    """bench_suite.py::bench_speculative_decode's operating point through the
    port on the 8B int8 chat model: 128 prompt ids, 128 new tokens, gamma 8,
    n-grams up to 3. The stepped greedy generate, the host loop and the
    on-device loop (each twice), the oracle curve (about 100%, 50% and 0%
    acceptance), then SpiderFree.chat with the speculative chat function
    beside the plain one."""
    import numpy as np
    import torch

    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models import speculative as S
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    L = model.config.num_hidden_layers
    ids = [int(t) for t in np.random.default_rng(0).integers(10, 5000, SPEC_PROMPT_TOKENS)]
    pcfg = S.PromptLookupConfig(max_new_tokens=SPEC_NEW_TOKENS, gamma=SPEC_GAMMA,
                                max_ngram=SPEC_MAX_NGRAM)
    windows = [0]
    verify = S._verify

    def counted(*a):
        windows[0] += 1
        return verify(*a)

    launches = dict.fromkeys(KERNELS, 0)
    runs, ok = {}, True
    S._verify = counted
    try:
        reset_launches()
        stepped, stepped_s = _generate_ids(model, ids, SPEC_NEW_TOKENS)
        counts, routes = read_launches(), read_route_launches()
        _add_launches(launches, counts)
        ok &= _flash_on_wgmma(counts, routes, L)
        runs["stepped"] = dict(seconds=stepped_s, tok_s=len(stepped) / stepped_s)

        def run(name, fn, **kw):
            nonlocal ok
            windows[0] = 0
            reset_launches()
            toks, s = _sync_s(lambda: fn(model, ids, pcfg, **kw))
            counts, routes = read_launches(), read_route_launches()
            _add_launches(launches, counts)
            w = windows[0]
            flash_ok = _flash_on_wgmma(counts, routes, L * (1 + w))
            ok &= flash_ok and len(toks) == SPEC_NEW_TOKENS
            runs[name] = dict(seconds=s, tok_s=len(toks) / s, windows=w,
                              tokens_per_window=(len(toks) - 1) / max(w, 1),
                              ms_per_window=s * 1e3 / max(w, 1),
                              flash_launches=counts["flash_fwd"],
                              flash_launches_expected=L * (1 + w), flash_ok=flash_ok)
            return toks

        host = [run(f"host_loop_{i}", S.speculative_generate) for i in range(2)]
        dev = [run(f"ondevice_{i}", S.speculative_generate_ondevice) for i in range(2)]
        curve = {}
        for label, kw in (("oracle_100", dict(oracle=dev[0])),
                          ("oracle_50", dict(oracle=dev[0], corrupt_every=4)),
                          ("oracle_0", dict(oracle=[0] * SPEC_NEW_TOKENS))):
            toks = run(label, S.speculative_generate_ondevice, **kw)
            runs[label]["stream_agree"] = _first_divergence(toks, dev[0])[0]
            curve[label] = runs[label]["tok_s"]
    finally:
        S._verify = verify
    prefix, equal = _first_divergence(dev[0], stepped)
    gap = None if equal else _stepped_gap(model, ids, stepped, prefix,
                                          len(ids) + SPEC_NEW_TOKENS)
    bits = host[0] == host[1] and dev[0] == dev[1] and host[0] == dev[0]
    ok &= bits and (equal or gap <= FLIP_GAP)
    yield dict(phase="speculative", model="llama3_8b int8 (random weights)",
               prompt_tokens=len(ids), new_tokens=SPEC_NEW_TOKENS, gamma=SPEC_GAMMA,
               max_ngram=SPEC_MAX_NGRAM, runs=runs, tok_s_vs_acceptance=curve,
               host_ondevice_equal_and_repeatable=bits, prefix_match_vs_stepped=prefix,
               equal_to_stepped=equal, stepped_top2_gap_at_divergence=gap,
               flip_gap_bound=FLIP_GAP, launches=launches, nvidia_smi=smi, ok=ok)

    # SpiderFree.chat: the speculative chat function beside the plain one;
    # each decoder's tokens are recorded (the byte-level tokenizer drops the
    # random model's ids past 255 from the text)
    from spider_tpu_torch.models import decode as D

    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    launches = dict.fromkeys(KERNELS, 0)
    chats, ok, streams, prompts = {}, True, {}, []
    real = {"plain": D.generate, "speculative": S.speculative_generate_ondevice}

    def plain_rec(m, emb, plen, gcfg, generator=None):
        out = real["plain"](m, emb, plen, gcfg, generator=generator)
        streams["plain"] = out["tokens"][0].tolist()
        return out

    def spec_rec(m, ids, pcfg):
        prompts.append(list(ids))
        streams["speculative"] = real["speculative"](m, ids, pcfg)
        return streams["speculative"]

    D.generate, S.speculative_generate_ondevice = plain_rec, spec_rec
    try:
        fns = {name: make_llama_chat_fn(model, tokenizer, max_new_tokens=SPEC_NEW_TOKENS,
                                        speculative=name == "speculative") for name in real}
    finally:
        D.generate = real["plain"]
    for name, fn in fns.items():
        timing = {}

        def chat_fn(prompt, fn=fn, timing=timing):
            text, timing["chat_s"] = timed_chat(fn, prompt)
            return text

        sf = SpiderFree(cfg, chat_fn=chat_fn)
        reset_launches()
        events, s = _sync_s(lambda: sf.chat(f"Describe {SD_CAPTION}.", task_prompt="TEXT")[0])
        counts, routes = read_launches(), read_route_launches()
        _add_launches(launches, counts)
        ok &= [k for k, _ in events] == ["text"] and on_ruled_route(routes)
        chats[name] = dict(seconds=s, chat_s=timing["chat_s"], text=events[0][1],
                           flash_launches=counts["flash_fwd"])
    S.speculative_generate_ondevice = real["speculative"]
    texts_equal = chats["plain"]["text"] == chats["speculative"]["text"]
    for c in chats.values():
        c["text_chars"] = len(c.pop("text"))
    prefix, equal = _first_divergence(streams["speculative"], streams["plain"])
    gap = None if equal else _stepped_gap(model, prompts[0], streams["plain"], prefix,
                                          len(prompts[0]) + SPEC_NEW_TOKENS)
    ok &= equal or gap <= FLIP_GAP
    yield dict(phase="speculative", part="spider_free_chat", prompt_tokens=len(prompts[0]),
               chats=chats, texts_equal=texts_equal, tokens_prefix_match=prefix,
               tokens_equal=equal, plain_top2_gap_at_divergence=gap, flip_gap_bound=FLIP_GAP,
               launches=launches, nvidia_smi=smi, ok=ok)


def phase_chat_stream(model, tokenizer, smi: str):
    """decode.stream_generate on the 8B int8 model: the 128-token chat
    prompt, 150 new tokens; its tokens against decode.generate's."""
    import torch

    from spider_tpu_torch.models.decode import GenerateConfig, stream_generate

    ids = tokenizer(CHAT_PROMPT, add_special_tokens=True).input_ids
    eos = (tokenizer.eos_token_id,)
    gcfg = GenerateConfig(max_new_tokens=NEW_TOKENS, eos_ids=eos,
                          pad_id=tokenizer.pad_token_id)
    with torch.inference_mode():
        emb = model.embed(torch.tensor([ids], device=model.device))
    plen = torch.tensor([len(ids)], dtype=torch.int32)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = stream_generate(model, emb, plen, gcfg)
    toks = [next(it)]
    ttft = time.perf_counter() - t0
    toks += list(it)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts, routes = read_launches(), read_route_launches()
    want, _ = _generate_ids(model, ids, NEW_TOKENS, eos, tokenizer.pad_token_id)
    if eos[0] in want:
        want = want[:want.index(eos[0]) + 1]
    L = model.config.num_hidden_layers
    return dict(phase="chat_stream", model="llama3_8b int8", prompt_tokens=len(ids),
                new_tokens=len(toks), time_to_first_token_ms=ttft * 1e3,
                tok_s=(len(toks) - 1) / (total - ttft), seconds=total,
                tokens_equal_generate=toks == want, launches=counts, route_launches=routes,
                nvidia_smi=smi, ok=toks == want and _flash_on_wgmma(counts, routes, L))


def phase_llm_batcher(model, tokenizer, smi: str):
    """serving/batcher.py::LlmBatcher on the 8B int8 model: 8 of the serving
    prompts submitted at once, 48 new tokens each. Each wave's tokens
    against a generate over the same right-padded, bucket-length array; the
    first BATCHER_SINGLE answers against decoding each prompt alone."""
    import torch

    from spider_tpu_torch.models.decode import GenerateConfig, generate
    from spider_tpu_torch.serving import batcher as BM

    prompts = serving_prompts(BATCHER_REQUESTS)
    pad = tokenizer.pad_token_id
    gcfg = GenerateConfig(max_new_tokens=SERVING_NEW_TOKENS, eos_ids=(tokenizer.eos_token_id,),
                          pad_id=pad)
    real = BM.generate
    produced = []

    def recorded(*a, **kw):
        out = real(*a, **kw)
        produced.append(out["tokens"])
        return out

    b = BM.LlmBatcher(model, tokenizer, gen_cfg=gcfg, max_batch_size=BATCHER_REQUESTS,
                      max_wait_s=0.2, length_bucket=128)
    waves = []
    run_wave = b._run_wave
    b._run_wave = lambda wave: (waves.append([ids for ids, _ in wave]), run_wave(wave))
    BM.generate = recorded
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [b.submit(p) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        seconds = time.perf_counter() - t0
        counts, routes = read_launches(), read_route_launches()
    finally:
        BM.generate = real
        b.close()
    same_bits = len(waves) == len(produced) == b.n_waves
    rows = {}
    for wave_ids, got in zip(waves, produced):
        arr, plen = b.pad_wave(wave_ids)
        with torch.inference_mode():
            emb = model.embed(torch.from_numpy(arr).to(model.device))
        want = generate(model, emb, torch.from_numpy(plen), gcfg)["tokens"]
        same_bits &= torch.equal(got, want)
        for ids, row in zip(wave_ids, got.tolist()):
            rows[tuple(ids)] = [t for t in row if t != pad]
    single = []
    for p in prompts[:BATCHER_SINGLE]:
        ids = tokenizer(p, add_special_tokens=True).input_ids
        alone = [t for t in _greedy_tokens(model, tokenizer, [p], SERVING_NEW_TOKENS)[0]]
        single.append(_first_divergence(alone, rows[tuple(ids)]))
    emitted = sum(len(r) for r in rows.values())
    L = model.config.num_hidden_layers
    return dict(phase="llm_batcher", model="llama3_8b int8", requests=len(prompts),
                new_tokens=SERVING_NEW_TOKENS, waves=b.n_waves,
                wave_sizes=[len(w) for w in waves], seconds=seconds,
                tok_s=emitted / seconds, emitted_tokens=emitted,
                waves_equal_generate_bits=same_bits,
                single_request_agreement=sum(eq for _, eq in single) / len(single),
                single_request_leading_equal=[n for n, _ in single],
                single_request_compared=len(single), launches=counts, route_launches=routes,
                nvidia_smi=smi,
                ok=same_bits and all(isinstance(o, str) for o in outs)
                and _flash_on_wgmma(counts, routes, L * b.n_waves))


def write_qwen2_checkpoint(directory: str, dev, layers: int):
    """A synthetic Qwen2-7B in the HF layout (model_type qwen2, q/k/v
    biases, config.json without attention_bias, as Qwen2's own): full width
    and vocabulary, `layers` layers, bf16, two shards. Returns (source model,
    {checkpoint key: tensor}, row)."""
    import dataclasses

    import torch

    from spider_tpu_torch.models import checkpoint_io as io
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import llama as L

    cfg = dataclasses.replace(L.qwen2_7b(), num_hidden_layers=layers, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    src = fill_synthetic_(L.LlamaForCausalLM(cfg, dev).eval(), CKPT_SEED + 1)
    rules = C.llama_rules({"lm_head.weight"}, cfg)
    hf = C.export_state_dict(rules, src.state_dict())
    order = [k for r in rules for k in r.keys]
    half = len(order) // 2
    io.save_sharded([lambda keys=keys: {k: hf[k].cpu() for k in keys}
                     for keys in (order[:half], order[half:])], directory)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
                       vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                       intermediate_size=cfg.intermediate_size, num_hidden_layers=layers,
                       num_attention_heads=cfg.num_attention_heads,
                       num_key_value_heads=cfg.num_key_value_heads,
                       max_position_embeddings=cfg.max_position_embeddings,
                       rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                       tie_word_embeddings=False, hidden_act="silu", torch_dtype="bfloat16"),
                  f, indent=2)
    gb = sum(t.numel() * t.element_size() for t in hf.values()) / 1e9
    return src, hf, dict(depth=layers, bias_keys=sum(k.endswith(".bias") for k in hf),
                         checkpoint_gb=gb, write_s=time.perf_counter() - t0)


def phase_qwen2(tokenizer, dev, smi: str):
    """qwen2_7b at full width and depth (28 layers, hidden 3584, 28/4 heads,
    D 128, vocabulary 152064, q/k/v biases random and nonzero) from a seed:
    int8 prefill T 128 + 32 greedy tokens; the same with mrope positions;
    the paged batcher; int4 generate; a synthetic Qwen2-layout checkpoint
    through from_pretrained('llama', path=...)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.serving.continuous import PagedContinuousBatcher

    N = FAMILY_NEW_TOKENS
    ids = tokenizer(CHAT_PROMPT, add_special_tokens=True).input_ids
    cfg8 = dataclasses.replace(L.qwen2_7b(), quantization="int8", param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _sync_s(lambda: factory.build_llama(cfg8, dev, seed=5))
    Ln = cfg8.num_hidden_layers
    bias = model.model.layers[0].self_attn.k_proj.bias
    _generate_ids(model, ids, 1)                                    # warm-up
    prefill_s = min(_generate_ids(model, ids, 1)[1] for _ in range(2))
    reset_launches()
    toks, gen_s = _generate_ids(model, ids, N)
    counts, routes = read_launches(), read_route_launches()
    plain = _greedy_by_positions(model, ids, N, streams=False)
    model_m = L.LlamaForCausalLM(dataclasses.replace(cfg8, mrope_section=MROPE_SECTION),
                                 dev).eval()
    model_m.load_state_dict(model.state_dict())
    mrope = _greedy_by_positions(model_m, ids, N, streams=True)
    del model_m
    torch.cuda.empty_cache()
    yield dict(phase="qwen2", part="int8_generate", model="qwen2_7b int8 (random weights)",
               layers=Ln, hidden=cfg8.hidden_size, heads=[cfg8.num_attention_heads,
                                                          cfg8.num_key_value_heads],
               vocab=cfg8.vocab_size, bias_nonzero=bool(bias.abs().max() > 0),
               build_s=build_s, prompt_tokens=len(ids), prefill_ms_T128=prefill_s * 1e3,
               new_tokens=N, generate_s=gen_s, decode_tok_s=(N - 1) / (gen_s - prefill_s),
               mrope_section=list(MROPE_SECTION), mrope_equal_plain=mrope == plain,
               positions_loop_equal_generate=plain == toks,
               device_gb=torch.cuda.memory_allocated() / 1e9, launches=counts,
               route_launches=routes, nvidia_smi=smi,
               ok=bool(bias.abs().max() > 0) and mrope == plain == toks
               and _flash_on_wgmma(counts, routes, Ln))

    # the paged batcher: 16 slots over 32 blocks of 128, as phase_serving's
    prompts = serving_prompts(QWEN2_PAGED_REQUESTS)
    cb = PagedContinuousBatcher(model, tokenizer, num_slots=16, max_len=512, max_new_tokens=N,
                                page=128, num_blocks=32)
    emitted = {}
    finish = cb._finish

    def record(slot):
        req = cb._requests[slot]
        finish(slot)
        emitted[id(req.future)] = list(req.emitted)

    cb._finish = record
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [cb.submit(p) for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    seconds = time.perf_counter() - t0
    counts, routes = read_launches(), read_route_launches()
    steps, prefills = cb.n_decode_steps, cb.n_prefills
    cb.close()
    compared = []
    for p, f in zip(prompts, futs):
        p_ids = tokenizer(p, add_special_tokens=True).input_ids
        fresh = _greedy_tokens(model, tokenizer, [p], N)[0]
        got = emitted[id(f)]
        n, equal = _first_divergence(got, fresh)
        gap = None if equal else _stepped_gap(model, p_ids, fresh, n, len(p_ids) + N)
        compared.append(dict(prompt_tokens=len(p_ids), leading_equal=n, equal=equal,
                             stepped_top2_gap_at_divergence=gap))
    want = dict(flash_fwd=Ln * prefills, paged_decode=Ln * steps, int4_matmul=0, tattn_fwd=0,
                flash_bwd_dq=0, flash_bwd_dkv=0, group_norm=0)
    yield dict(phase="qwen2", part="paged_batcher", model="qwen2_7b int8", requests=len(prompts),
               new_tokens=N, seconds=seconds, tok_s=sum(len(v) for v in emitted.values()) / seconds,
               decode_steps=steps, prefills=prefills, launches=counts, launches_expected=want,
               route_launches=routes, against_fresh_greedy=compared, flip_gap_bound=FLIP_GAP,
               nvidia_smi=smi,
               ok=all(isinstance(o, str) for o in outs) and counts == want
               and routes["paged_decode"] == dict(split=Ln * steps, simple=0)
               and on_ruled_route(routes)
               and all(c["equal"] or c["stepped_top2_gap_at_divergence"] <= FLIP_GAP
                       for c in compared))
    del model, cb
    torch.cuda.empty_cache()

    # int4 generate
    cfg4 = dataclasses.replace(L.qwen2_7b(), quantization="int4", param_dtype=torch.bfloat16)
    model4 = factory.build_llama(cfg4, dev, seed=5)
    _generate_ids(model4, ids, 2)                                   # warm-up
    reset_launches()
    toks4, gen4_s = _generate_ids(model4, ids, N)
    counts, routes = read_launches(), read_route_launches()
    want4 = int4_route_counts(cfg4, N - 1, 1)
    yield dict(phase="qwen2", part="int4_generate", model="qwen2_7b int4", new_tokens=N,
               generate_s=gen4_s, tok_s=N / gen4_s, int4_launches=counts["int4_matmul"],
               int4_routes=routes["int4_matmul"], int4_routes_expected=want4,
               launches=counts, route_launches=routes, nvidia_smi=smi,
               ok=len(toks4) == N and routes["int4_matmul"] == want4
               and counts["int4_matmul"] == (7 * Ln + 1) * N
               and _flash_on_wgmma(counts, routes, Ln))
    del model4
    torch.cuda.empty_cache()

    # a synthetic Qwen2-layout checkpoint, cut to QWEN2_CKPT_LAYERS layers
    root = tempfile.mkdtemp(prefix="spider_qwen2_")
    try:
        src, hf, row = write_qwen2_checkpoint(root, dev, QWEN2_CKPT_LAYERS)
        (loaded, _), load = _timed_load(
            lambda: factory.from_pretrained("llama", path=root, device=dev))
        cfgc = dataclasses.replace(src.config, quantization="int8")
        ref = L.LlamaForCausalLM(cfgc, dev).eval()
        ref.load_state_dict(C.convert_llama_state_dict(hf, cfgc, "int8"), strict=True)
        bad = _states_equal(loaded.state_dict(), ref.state_dict())
        lc = loaded.config
        cfg_ok = (lc.attention_bias and not lc.tie_word_embeddings
                  and lc.num_hidden_layers == QWEN2_CKPT_LAYERS
                  and all(getattr(lc, f) == getattr(cfg8, f) for f in (
                      "vocab_size", "hidden_size", "intermediate_size", "num_attention_heads",
                      "num_key_value_heads", "rms_norm_eps", "rope_theta")))
        t_ids = torch.tensor([ids], dtype=torch.long, device=dev)
        reset_launches()
        got = _greedy(loaded, t_ids, N)
        counts, routes = read_launches(), read_route_launches()
        want = _greedy(ref, t_ids, N)
        yield dict(phase="qwen2", part="checkpoint", model=f"qwen2_7b, {QWEN2_CKPT_LAYERS} of "
                   f"28 layers (cut)", **row, **load, read_gb_per_s=row["checkpoint_gb"]
                   / load["load_s"], tensors=len(ref.state_dict()), tensors_differing=bad[:8],
                   config_read=cfg_ok, tokens_equal=got == want, launches=counts,
                   route_launches=routes, nvidia_smi=smi,
                   ok=not bad and cfg_ok and got == want
                   and row["bias_keys"] == 3 * QWEN2_CKPT_LAYERS
                   and _flash_on_wgmma(counts, routes, QWEN2_CKPT_LAYERS))
        del src, hf, loaded, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_llama2(tokenizer, dev, smi: str):
    """llama2_7b int8 at full width and depth (MHA 32/32, vocabulary 32000)
    from a seed: prefill T 128 + 32 greedy tokens."""
    import dataclasses

    import torch

    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L

    ids = tokenizer(CHAT_PROMPT, add_special_tokens=True).input_ids
    cfg = dataclasses.replace(L.llama2_7b(), quantization="int8", param_dtype=torch.bfloat16)
    model, build_s = _sync_s(lambda: factory.build_llama(cfg, dev, seed=6))
    _generate_ids(model, ids, 1)                                    # warm-up
    prefill_s = min(_generate_ids(model, ids, 1)[1] for _ in range(2))
    reset_launches()
    toks, gen_s = _generate_ids(model, ids, FAMILY_NEW_TOKENS)
    counts, routes = read_launches(), read_route_launches()
    row = dict(phase="llama2", model="llama2_7b int8 (random weights)",
               layers=cfg.num_hidden_layers, heads=[cfg.num_attention_heads,
                                                    cfg.num_key_value_heads],
               vocab=cfg.vocab_size, build_s=build_s, prompt_tokens=len(ids),
               prefill_ms_T128=prefill_s * 1e3, new_tokens=len(toks), generate_s=gen_s,
               decode_tok_s=(len(toks) - 1) / (gen_s - prefill_s),
               device_gb=torch.cuda.memory_allocated() / 1e9, launches=counts,
               route_launches=routes, nvidia_smi=smi,
               ok=len(toks) == FAMILY_NEW_TOKENS
               and _flash_on_wgmma(counts, routes, cfg.num_hidden_layers))
    del model
    torch.cuda.empty_cache()
    return row


class plain_llama_attention:
    """Within the block every flash_attention call of models/llama.py takes
    mha_reference instead (the comparison run of phase_moe)."""

    def __enter__(self):
        from spider_tpu_torch.models import llama as L
        from spider_tpu_torch.ops.attention import mha_reference

        self.real = L.flash_attention
        L.flash_attention = lambda q, k, v, **kw: mha_reference(q, k, v, **kw)

    def __exit__(self, *exc):
        from spider_tpu_torch.models import llama as L

        L.flash_attention = self.real


def phase_moe(dev, smi: str):
    """A Llama at llama3_8b widths (hidden 4096, intermediate 14336, 32/8
    heads, vocabulary 128256) cut to MOE_LAYERS layers with MOE_EXPERTS
    experts (fp32 parameters, bf16 compute): top-1 and top-2 forwards over a
    T 128 prompt against the same model with plain attention, then one
    make_lm_train_step at [4, 512] with the aux term."""
    import dataclasses

    import torch

    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.runners.train_step import build_optimizer, make_lm_train_step

    cfg1 = dataclasses.replace(L.llama3_8b(), num_hidden_layers=MOE_LAYERS,
                               num_experts=MOE_EXPERTS, moe_top_k=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m1 = factory.build_llama(cfg1, dev, seed=7)
    experts = sum(p.numel() for n, p in m1.named_parameters() if n.endswith((".w1", ".w2")))
    g = torch.Generator(device=dev).manual_seed(12)
    ids = torch.randint(3, cfg1.vocab_size, (1, MOE_PROMPT_TOKENS), generator=g, device=dev)

    for top_k in (1, 2):
        m = m1
        if top_k == 2:
            m = L.LlamaForCausalLM(dataclasses.replace(cfg1, moe_top_k=2), dev).eval()
            m.load_state_dict(m1.state_dict())
        picks = []

        def hook(mod, inputs, out, picks=picks):
            x = inputs[0].reshape(-1, inputs[0].shape[-1]).float()
            picks.append((x @ mod.wg).topk(mod.cfg.moe_top_k, dim=-1).indices.sort(-1).values)

        handles = [layer.mlp.register_forward_hook(hook) for layer in m.model.layers]
        with torch.inference_mode():
            reset_launches()
            routed = m(input_ids=ids)[0][0].float()
            torch.cuda.synchronize()
            counts, routes = read_launches(), read_route_launches()
            aux = m.moe_aux_losses().tolist()
            with plain_llama_attention():
                plain = m(input_ids=ids)[0][0].float()
        for h in handles:
            h.remove()
        same = torch.ones(MOE_PROMPT_TOKENS, dtype=torch.bool, device=dev)
        for a, b in zip(picks[:MOE_LAYERS], picks[MOE_LAYERS:]):
            same &= (a == b).all(-1)
        diff_same = (routed[same] - plain[same]).abs().max().item()
        _, agree, scale = _logit_agreement(routed, plain)
        yield dict(phase="moe", part=f"forward_top{top_k}",
                   model=f"llama3_8b widths, {MOE_LAYERS} of 32 layers (cut), {MOE_EXPERTS} "
                   "experts", expert_params=experts, prompt_tokens=MOE_PROMPT_TOKENS,
                   aux=aux, tokens_routed_alike=int(same.sum()),
                   logits_max_abs_diff_routed_alike=diff_same, logits_max_abs=scale,
                   argmax_agree_share=agree, launches=counts, route_launches=routes,
                   bounds=dict(logits_atol=LOGIT_ATOL, agree_min=AGREE_MIN), nvidia_smi=smi,
                   ok=bool(torch.isfinite(routed).all()) and diff_same <= LOGIT_ATOL
                   and agree >= AGREE_MIN and _flash_on_wgmma(counts, routes, MOE_LAYERS))
        if m is not m1:
            del m
        del routed, plain
        torch.cuda.empty_cache()

    # the experts, gates, attention and norms train; the two vocabulary
    # matrices stay frozen, as the Spider trainer keeps its base
    B, T = TRAIN_LM_SHAPE
    for p in (m1.embed_tokens.weight, m1.lm_head.weight):
        p.requires_grad_(False)
    opt = build_optimizer(3e-4, params={n: p for n, p in m1.named_parameters()
                                        if p.requires_grad}, weight_decay=0.01)
    step = make_lm_train_step(m1, opt)
    m1.train()
    ids = torch.randint(3, cfg1.vocab_size, (B, T), generator=g, device=dev)
    labels = ids.clone()
    labels[:, : T // 4] = -100
    reset_launches()
    metrics, s = _sync_s(lambda: step(dict(input_ids=ids, labels=labels)))
    counts, routes = read_launches(), read_route_launches()
    metrics = {k: float(v) for k, v in metrics.items()}
    want = dict(flash_fwd=MOE_LAYERS, flash_bwd_dq=MOE_LAYERS, flash_bwd_dkv=MOE_LAYERS,
                tattn_fwd=0, paged_decode=0, int4_matmul=0, group_norm=0)
    row = dict(phase="moe", part="lm_train_step", batch=B, seq_len=T, seconds=s,
               trained_params=sum(p.numel() for p in opt.params.values()), metrics=metrics, peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               launches=counts, launches_expected=want, route_launches=routes,
               nvidia_smi=smi,
               ok=all(v == v and abs(v) < float("inf") for v in metrics.values())
               and counts == want and on_ruled_route(routes))
    del opt, step, m1
    torch.cuda.empty_cache()
    yield row


def family_phases(model, tokenizer, dev, smi: str):
    """The phases of the Llama family's rest, in order, each row as it is
    done: speculative, chat_stream, llm_batcher on the 8B chat model, then
    qwen2, llama2 and moe, each freeing its models before the next."""
    yield from phase_speculative(model, tokenizer, smi)
    yield phase_chat_stream(model, tokenizer, smi)
    yield phase_llm_batcher(model, tokenizer, smi)
    yield from phase_qwen2(tokenizer, dev, smi)
    yield phase_llama2(tokenizer, dev, smi)
    yield from phase_moe(dev, smi)


# ---------------------------------------------------------------------------
# The SDXL story path (pipelines/sdxl_story.py): StoryDiffusion's consistent
# self-attention at the reference's operating point
# ---------------------------------------------------------------------------

STORY_HW = 768
STORY_GENERAL = "a fox explorer"
STORY_PROMPTS = ["wakes up in a forest", "finds a map", "sails a river", "reaches home"]
STORY_STYLE = "Comic book"
STORY_ID_LENGTH = 4
STORY_SA_RATIO = 0.5
STORY_STEPS = 50
STORY_TIMED_STEPS = 5                 # denoise steps a batched-vs-split timing takes
STORY_SPAN = (f" <IMAGESTORY><GENERALPROMPT>{STORY_GENERAL}</GENERALPROMPT>"
              f"<PROMPTARRAY>{json.dumps(STORY_PROMPTS)}</PROMPTARRAY>"
              f"<STYLENAME>{STORY_STYLE}</STYLENAME></IMAGESTORY>")
PHOTOMAKER_SEED = 5


def story_bank_shapes(cfg, lat_h: int, lat_w: int):
    """(up level, transformer blocks per UNet call, T, heads, D, bank keys)
    of every up level whose blocks take a story bank at STORY_ID_LENGTH and
    STORY_SA_RATIO: each block runs one bank attention of [2 groups,
    frames x T] queries over the bank keys (batched CFG)."""
    n = len(cfg.block_out_channels)
    shapes = []
    for i in range(n):
        lvl = n - 1 - i
        depth = cfg.transformer_layers_per_block[lvl]
        if cfg.cross_attn_blocks[lvl] and depth > 0:
            T = (lat_h >> lvl) * (lat_w >> lvl)
            H = cfg.num_attention_heads[lvl]
            keys = max(1, int(STORY_ID_LENGTH * T * STORY_SA_RATIO))
            shapes.append((f"up_{i}", (cfg.layers_per_block + 1) * depth, T, H,
                           cfg.block_out_channels[lvl] // H, keys))
    return shapes


def story_flash_launches_per_unet_call(cfg, lat_h: int, lat_w: int, ctx_len: int,
                                       batch: int) -> int:
    """Flash launches in one story UNet call: each transformer block's self-
    and cross-attention where ops.attention.spatial_flash_predicate holds (a story
    block's self-attention goes through attention_with_lse by the same rule),
    plus one bank attention in each transformer block of the up blocks where
    the same predicate holds for the bank's shape."""
    from spider_tpu_torch.ops.attention import spatial_flash_predicate

    groups = 2
    bank = sum(blocks for _, blocks, T, H, D, K in story_bank_shapes(cfg, lat_h, lat_w)
               if spatial_flash_predicate(groups, len(STORY_PROMPTS) * T, K, H, D))
    return flash_launches_per_unet_call(cfg, lat_h, lat_w, ctx_len, batch) + bank


def phase_story_bank_routing(dev):
    """The story bank attention at the SDXL story point (768 px, 4 frames,
    id_length 4, sa_ratio 0.5, batched CFG: 2 groups): [2, 4 T] queries over
    the bank keys through ops.attention.attention_with_lse on the flash kernel and in
    its plain form, device ms, with the bound and one SDPA call on the same
    q, k, v (which returns no lse). Inputs as routing_qkv makes them. Output
    (by routing_excess) and lse are held to the plain form on the same inputs
    in fp32 (the bf16 plain form's own errors are reported beside). The row
    fails if the predicate does not route the shape to the kernel, if the
    kernel is slower than the bf16 plain form by more than ROUTING_SLACK, or
    if it disagrees with the fp32 form."""
    import torch

    from spider_tpu_torch.models.unet2d import unet_sdxl
    from spider_tpu_torch.ops.attention import (attention_with_lse, spatial_flash_config,
                                                spatial_flash_predicate)

    lat = STORY_HW // 8
    rows = []
    for level, blocks, T, H, D, K in story_bank_shapes(unet_sdxl(), lat, lat):
        B, Tq = 2, len(STORY_PROMPTS) * T
        q, k, v = routing_qkv(dev, 900 + len(rows), B, Tq, K, H * D)
        flash = lambda: attention_with_lse(q, k, v, H)
        reset_launches()
        out, lse = flash()
        routed = read_launches()["flash_fwd"] == 1
        with spatial_flash_config("einsum"):
            plain = lambda: attention_with_lse(q, k, v, H)
            got_plain, plain_lse = plain()
            plain_dev = device_ms(plain, calls=5)
            # held as the kernel rows are, to the same inputs in fp32: the bf16
            # plain form rounds its logits to bf16 before the softmax
            want, want_lse = attention_with_lse(q.float(), k.float(), v.float(), H)
        err = (out.float() - want).abs().max().item()
        excess = routing_excess(out, want)
        typical = want.abs().mean().item()
        lse_err = (lse - want_lse).abs().max().item()
        plain_err = (got_plain.float() - want).abs().max().item()
        plain_lse_err = (plain_lse - want_lse).abs().max().item()
        del want, want_lse, out, lse, got_plain, plain_lse
        torch.cuda.empty_cache()
        flash_dev, flash_ms = device_ms(flash), cuda_ms(flash)
        qs, ks, vs = (x.reshape(B, -1, H, D).transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        library_dev = device_ms(sdpa)
        moved = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * Tq   # bf16; lse fp32
        bound = bound_ms(moved, 4 * B * H * Tq * K * D)
        rows.append(dict(phase="unet_routing", model="sdxl_story_768px", level=level,
                         kind="bank", blocks_per_unet_call=blocks, B=B, T=Tq, S=K, heads=H,
                         D=D, flash_device_ms=flash_dev, einsum_device_ms=plain_dev,
                         flash_ms=flash_ms, sdpa_device_ms=library_dev, max_abs_err=err,
                         mean_abs_out=typical, tolerance_excess=excess,
                         lse_max_abs_err=lse_err, plain_bf16_max_abs_err=plain_err,
                         plain_bf16_lse_max_abs_err=plain_lse_err, **bound,
                         share_of_bound=bound["bound_ms"] / flash_dev,
                         predicate_routes_to_flash=bool(
                             spatial_flash_predicate(B, Tq, K, H, D)),
                         ok=routed and excess <= 0 and lse_err <= LSE_ATOL
                         and flash_dev <= ROUTING_SLACK * plain_dev))
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


def phase_tattn_grad(dev):
    """Gradients through temporal_attention's kernel call (a
    torch.autograd.Function whose backward is the plain form's vjp) at
    ZeroScope's four levels, bf16 on the "ring" route and fp32 on "simple",
    against autograd through temporal_attention_reference, at the kernel
    rows' tolerances; one kernel launch a call, none in the backward."""
    import torch

    from spider_tpu_torch.ops import temporal_attention as TA

    levels = [("L0", 2880, 320), ("L1", 720, 640), ("L2", 180, 1280), ("mid", 45, 1280)]
    rows = []
    for dtype, atol, rtol in ((torch.bfloat16, OUT_ATOL, BF16_EPS), (torch.float32, 1e-4, 0.0)):
        for name, P, C in levels:
            g = torch.Generator(device=dev).manual_seed(300 + len(rows))
            q, k, v, dout = (torch.randn((2, 16, P, C), generator=g, device=dev, dtype=dtype)
                             for _ in range(4))
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = TA.temporal_attention.launches
            out = TA.temporal_attention(*leaves, 8)
            grads = torch.autograd.grad(out, leaves, dout)
            torch.cuda.synchronize()
            launched = TA.temporal_attention.launches - before
            plain = [x.clone().requires_grad_() for x in (q, k, v)]
            want = torch.autograd.grad(TA.temporal_attention_reference(*plain, 8), plain, dout)
            excess = max(((a.float() - b.float()).abs() - (atol + rtol * b.float().abs()))
                         .max().item() for a, b in zip(grads, want))
            errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, want)]
            rows.append(dict(level=name, D=C // 8, route=TA.tattn_route(dtype),
                             dtype=str(dtype), max_abs_err_dq_dk_dv=errs,
                             excess_over_bound=excess, launches=launched,
                             ok=excess <= 0 and launched == 1
                             and all(bool(torch.isfinite(a).all()) for a in grads)))
            del q, k, v, dout, leaves, plain, out, grads, want
    return dict(phase="tattn_grad", rows=rows, ok=all(r["ok"] for r in rows))


def _story_unet_inputs(pipe, dev):
    """One batched-CFG UNet call of the story at its operating point: latents
    [8, 96, 96, 4], the encoded prompts, the time ids and the story dict."""
    import numpy as np
    import torch

    B, lat = len(STORY_PROMPTS), STORY_HW // 8
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((B, lat, lat, 4), generator=g, device=dev)
    ctx, pooled = pipe.encode_prompt(STORY_PROMPTS)
    un_ctx, un_pooled = pipe.encode_prompt([""] * B)
    time_ids = torch.tensor([[STORY_HW, STORY_HW, 0, 0, STORY_HW, STORY_HW]],
                            dtype=torch.float32, device=dev).repeat(2 * B, 1)
    idx = pipe._story_indices(STORY_ID_LENGTH, (lat, lat), STORY_SA_RATIO,
                              np.random.default_rng(0))
    story = {p: dict(id_length=STORY_ID_LENGTH, indices=i, num_groups=2)
             for p, i in idx.items()}
    return (torch.cat([x, x]), torch.full((2 * B,), 981, dtype=torch.int32, device=dev),
            torch.cat([un_ctx, ctx]),
            dict(text_embeds=torch.cat([un_pooled, pooled]), time_ids=time_ids), story)


def phase_story_check(pipe, dev):
    """One full-size story UNet call (SDXL 768 px, 4 frames with id_length 4,
    batched CFG, consistent self-attention on the up blocks) in bf16 routed
    as the story path routes it (self-, cross- and bank attention where
    spatial_flash_predicate holds, every GroupNorm on its kernel), the same
    call with plain bf16 attention and plain GroupNorms everywhere, and an
    fp32 copy of the UNet (plain attention, plain GroupNorms): the kernels
    may be at most UNET_REL_SLACK (plus 1e-3) less accurate against fp32
    than the plain path, and the routed call launches exactly the derived
    count, all on the wgmma route."""
    import dataclasses

    import torch

    from spider_tpu_torch.models.unet2d import UNet2DConditionModel
    from spider_tpu_torch.ops.attention import spatial_flash_config
    from spider_tpu_torch.ops.group_norm import group_norm_config

    x, t, ctx, cond, story = _story_unet_inputs(pipe, dev)
    lat = STORY_HW // 8
    want = story_flash_launches_per_unet_call(pipe.unet.config, lat, lat, 77, x.shape[0])
    with torch.inference_mode():
        reset_launches()
        routed = pipe.unet(x, t, ctx, added_cond=cond, story=story).float()
        torch.cuda.synchronize()
        launches, routes = read_launches(), read_route_launches()
        with spatial_flash_config("einsum"), group_norm_config("plain"):
            plain = pipe.unet(x, t, ctx, added_cond=cond, story=story).float()
            torch.cuda.synchronize()
            plain_launches = read_launches()["flash_fwd"] - launches["flash_fwd"]
            ref_unet = UNet2DConditionModel(
                dataclasses.replace(pipe.unet.config, dtype=torch.float32), dev).eval()
            ref_unet.load_state_dict(pipe.unet.state_dict())
            ref = ref_unet(x, t, ctx.float(), added_cond={k: v.float() for k, v in cond.items()},
                           story=story)
    del ref_unet
    torch.cuda.empty_cache()
    err_kernel, err_plain = _rel_errors(routed, plain, ref)
    return dict(phase="story_check", batch=x.shape[0], latent_hw=[lat, lat],
                rel_err_kernel_vs_fp32=err_kernel, rel_err_plain_vs_fp32=err_plain,
                flash_launches=launches["flash_fwd"], flash_launches_expected=want,
                flash_route_launches=routes["flash_fwd"], plain_form_flash_launches=plain_launches,
                ok=bool(torch.isfinite(routed).all())
                and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3
                and launches["flash_fwd"] == want == routes["flash_fwd"]["wgmma"]
                and plain_launches == 0)


def phase_story_profile(pipe, dev):
    """Where a story denoise step's device time goes: one torch.profiler pass
    over three full-size story UNet calls (batch 8: 4 frames with batched
    CFG, 768px, consistent self-attention on the up blocks); a batched
    denoise step is one such call."""
    import torch

    x, t, ctx, cond, story = _story_unet_inputs(pipe, dev)

    def call():
        with torch.inference_mode():
            pipe.unet(x, t, ctx, added_cond=cond, story=story)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / 3
    return dict(phase="story_step_profile", model="SDXL story UNet 768px, 4 frames, batched CFG",
                **_device_profile(call, seconds, top=12), ok=True)


def _timed_story_pipe(pipe, timing: dict):
    """Record the seconds of `pipe`'s prompt encoding, denoise loop and VAE
    decode into `timing` (instance attributes over the methods, each call
    ended by a synchronise); _untimed_story_pipe takes them away."""
    import torch

    def timed(key, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timing[key] = timing.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    cls = type(pipe)
    pipe.encode_prompt = timed("encode_s", cls.encode_prompt.__get__(pipe))
    pipe.encode_prompt_photomaker = timed("encode_s",
                                          cls.encode_prompt_photomaker.__get__(pipe))
    pipe._decode_latents = timed("vae_s", cls._decode_latents.__get__(pipe))
    pipe._denoise_fn = lambda *a: timed("denoise_s", cls._denoise_fn(pipe, *a))


def _untimed_story_pipe(pipe):
    for name in ("encode_prompt", "encode_prompt_photomaker", "_decode_latents", "_denoise_fn"):
        pipe.__dict__.pop(name, None)


def _frames_ok(frames, n: int, hw: int) -> dict:
    import numpy as np

    arr = np.stack([np.asarray(f, np.float32) for f in frames]) if frames else np.zeros(0)
    return dict(frames=len(frames), shape=list(arr.shape[1:]),
                range=[float(arr.min()), float(arr.max())] if arr.size else None,
                ok=bool(len(frames) == n and list(arr.shape[1:]) == [hw, hw, 3]
                        and np.isfinite(arr).all() and arr.min() >= 0.0 and arr.max() <= 1.0))


def _story_cfg_timing(pipe, dev) -> dict:
    """Steps/s and peak GB of STORY_TIMED_STEPS denoise steps with batched CFG
    (one [8] UNet call a step, two consistency groups) and with split CFG
    (two [4] calls a step, one group each), in turns batched, split, split,
    batched; each form's better run. The pipeline's rule is put back after."""
    import numpy as np
    import torch

    lat = STORY_HW // 8
    B = len(STORY_PROMPTS)
    ctx, pooled = pipe.encode_prompt(STORY_PROMPTS)
    un_ctx, un_pooled = pipe.encode_prompt([""] * B)
    time_ids = torch.tensor([[STORY_HW, STORY_HW, 0, 0, STORY_HW, STORY_HW]],
                            dtype=torch.float32, device=dev).repeat(B, 1)
    idx = pipe._story_indices(STORY_ID_LENGTH, (lat, lat), STORY_SA_RATIO,
                              np.random.default_rng(0))
    key = tuple(sorted((p, int(v.shape[0])) for p, v in idx.items()))
    shape = (B, lat, lat, 4)
    x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(17), device=dev)
    rule = pipe.batched_cfg
    out = {}
    for batched in (True, False, False, True):
        pipe.batched_cfg = batched
        run = pipe._denoise_fn(STORY_TIMED_STEPS, 5.0, shape, STORY_ID_LENGTH, key)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run(x, ctx, pooled, un_ctx, un_pooled, time_ids, idx)
        torch.cuda.synchronize()
        rate = STORY_TIMED_STEPS / (time.perf_counter() - t0)
        name = "batched" if batched else "split"
        out[f"{name}_steps_per_s"] = max(out.get(f"{name}_steps_per_s", 0.0), rate)
        out[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    pipe.batched_cfg = rule
    return out


def phase_story(model, tokenizer, dev, smi: str):
    """The SDXL story path at full width (768 px, 4 frames with id_length 4,
    sa_ratio 0.5, 50 Euler steps, CFG 5.0, bf16, random weights from a seed):
    from_pretrained('sdxl_story'), then story_check, the batched-vs-split CFG
    timing, one story_generation through the serving wiring (the
    functools.partial of it that SpiderFree takes as its story_fn), one
    SpiderFree.chat through the HTTP server whose chat function appends a
    fixed IMAGESTORY span to the 8B model's reply, and one PhotoMaker run
    (photomaker_v1 width, two seeded 224 px id images). Yields each row as it
    is done; the main-path rows carry their launches."""
    import base64
    import functools
    import http.client
    import io

    import numpy as np
    import torch
    from PIL import Image

    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models.photomaker import build_full_photomaker
    from spider_tpu_torch.models.pipelines.sdxl_story import story_generation
    from spider_tpu_torch.serving.http_server import serve
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    t0 = time.perf_counter()
    pipe = factory.from_pretrained("sdxl_story", device=dev, seed=4)
    build_s = time.perf_counter() - t0
    assert pipe.batched_cfg and (pipe.height, pipe.width) == (STORY_HW, STORY_HW)
    yield dict(nvidia_smi=smi, build_s=build_s, **phase_story_check(pipe, dev))
    yield dict(nvidia_smi=smi, **phase_story_profile(pipe, dev))
    cfg_timing = _story_cfg_timing(pipe, dev)

    lat = STORY_HW // 8
    per_call = story_flash_launches_per_unet_call(pipe.unet.config, lat, lat, 77,
                                                  2 * len(STORY_PROMPTS))
    want_flash = STORY_STEPS * per_call
    story_fn = functools.partial(story_generation, pipe, id_length=STORY_ID_LENGTH,
                                 sa_ratio=STORY_SA_RATIO, num_inference_steps=STORY_STEPS,
                                 height=STORY_HW, width=STORY_HW)
    timing = {}
    _timed_story_pipe(pipe, timing)
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = story_fn(general_prompt=STORY_GENERAL, prompt_array=STORY_PROMPTS,
                          style_name=STORY_STYLE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, routes = read_launches(), read_route_launches()
        media = _frames_ok(frames, len(STORY_PROMPTS), STORY_HW)
        yield dict(phase="story", nvidia_smi=smi, steps=STORY_STEPS,
                   frames=len(STORY_PROMPTS), id_length=STORY_ID_LENGTH,
                   sa_ratio=STORY_SA_RATIO, hw=STORY_HW, seconds=seconds,
                   encode_s=timing.get("encode_s"), denoise_s=timing.get("denoise_s"),
                   vae_s=timing.get("vae_s"), steps_per_s=STORY_STEPS / timing["denoise_s"],
                   **cfg_timing, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                   media=media, flash_launches_per_unet_call=per_call,
                   flash_expected=want_flash, launches=launches, route_launches=routes,
                   ok=media["ok"] and launches["flash_fwd"] == want_flash
                   and on_ruled_route(routes) and launches["tattn_fwd"] == 0)

        # SpiderFree through the HTTP server, with the story_fn wired in
        llm_chat = make_llama_chat_fn(model, tokenizer, max_new_tokens=NEW_TOKENS)
        cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
        sf = SpiderFree(cfg, chat_fn=lambda p: llm_chat(p) + STORY_SPAN, story_fn=story_fn)
        server = serve(sf, port=0, background=True)
        try:
            timing.clear()
            reset_launches()
            conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                              timeout=600)
            t0 = time.perf_counter()
            conn.request("POST", "/chat", json.dumps(dict(text="Tell me a story of a fox.",
                                                          stream=False)),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            seconds = time.perf_counter() - t0
            conn.close()
        finally:
            server.shutdown()
            server.server_close()
        launches, routes = read_launches(), read_route_launches()
        kinds = [e["kind"] for e in out["events"]]
        pngs = [np.asarray(Image.open(io.BytesIO(base64.b64decode(b))), np.float32) / 255.0
                for e in out["events"] if e["kind"] == "story" for b in e["data"]]
        media = _frames_ok(pngs, len(STORY_PROMPTS), STORY_HW)
        want_http = model.config.num_hidden_layers + want_flash
        yield dict(phase="story_http", status=resp.status, events=kinds, seconds=seconds,
                   denoise_s=timing.get("denoise_s"), media=media, launches=launches,
                   route_launches=routes, flash_expected=want_http,
                   ok=resp.status == 200 and kinds == ["story"] and media["ok"]
                   and launches["flash_fwd"] == want_http and on_ruled_route(routes))

        # PhotoMaker: the ref-image story mode at photomaker_v1 width
        free_gb = torch.cuda.mem_get_info(dev)[0] / 1e9
        pm = build_full_photomaker(device=dev, seed=PHOTOMAKER_SEED)
        rng = np.random.default_rng(PHOTOMAKER_SEED)
        refs = [(rng.random((224, 224, 3)) * 255).astype(np.uint8) for _ in range(2)]
        timing.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = story_fn(general_prompt="a man img", prompt_array=STORY_PROMPTS,
                          style_name=STORY_STYLE, ref_images=refs, id_encoder=pm)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, routes = read_launches(), read_route_launches()
        media = _frames_ok(frames, len(STORY_PROMPTS), STORY_HW)
        yield dict(phase="story_photomaker", free_gb_before=free_gb, id_images=len(refs),
                   seconds=seconds, encode_s=timing.get("encode_s"),
                   denoise_s=timing.get("denoise_s"), vae_s=timing.get("vae_s"), media=media,
                   launches=launches, route_launches=routes, flash_expected=want_flash,
                   ok=media["ok"] and launches["flash_fwd"] == want_flash
                   and on_ruled_route(routes))
    finally:
        _untimed_story_pipe(pipe)


# ---------------------------------------------------------------------------
# Grounding and segmentation: Grounding DINO (BOX) and SAM ViT-H (MASK)
# ---------------------------------------------------------------------------

GROUNDING_HW = (480, 640)             # the seeded uint8 image the BOX and MASK phases take
GROUNDING_CAPTION = "a horse . a rider . a dog ."
MASK_CAPTION = "a horse"
GROUNDING_CALLS = 3                   # timed GroundingDINOInference calls after a warm-up
GROUNDING_LABELS = ("grounding::msda", "sam::vit_attention")


def grounding_attention_shapes():
    """(model, where, kind, calls per model call, B, T, S, heads, D) of every
    attention of Grounding DINO (at 512 px) and of SAM ViT-H's mask decoder
    that goes through ops.attention.attention: the DINO decoder's query
    self-attention (900 queries, 8 heads of 32); SAM's prompt-token
    self-attention, token-to-image (twice in the two-way blocks and once at
    the end) and image-to-token over the 64 x 64 grid, for a box prompt (2
    corner tokens beside the 5 output tokens, batch 1: the MASK decoder) and
    for the MASK train step's text prompt (1 token, batch TRAIN_BATCH)."""
    from spider_tpu_torch.models.dino import grounding_dino_tiny
    from spider_tpu_torch.models.sam import sam_vit_h

    d, s = grounding_dino_tiny(), sam_vit_h()
    rows = [("grounding_dino_512px", "decoder", "self", d.dec_layers, 1, d.num_queries,
             d.num_queries, d.num_heads, d.hidden_dim // d.num_heads)]
    grid, h, depth = s.embed_hw ** 2, s.decoder_heads, s.decoder_depth
    D, Dx = s.prompt_embed_dim // h, s.prompt_embed_dim // 2 // h
    out_tokens = s.num_multimask_outputs + 2                 # the iou token and 4 mask tokens
    for model, B, n in (("sam_vit_h_box", 1, out_tokens + 2),
                        ("sam_vit_h_mask_step", TRAIN_BATCH, out_tokens + 1)):
        rows += [(model, "mask_decoder", "self", depth, B, n, n, h, D),
                 (model, "mask_decoder", "token_to_image", depth + 1, B, n, grid, h, Dx),
                 (model, "mask_decoder", "image_to_token", depth, B, grid, n, h, Dx)]
    return rows


def grounding_flash_calls(model: str, batch: int = None) -> int:
    """Flash launches of one call of `model` (a grounding_attention_shapes
    name), at its own batch or at `batch`: its attentions that
    ops.attention.spatial_flash_predicate routes there."""
    from spider_tpu_torch.ops.attention import spatial_flash_predicate

    return sum(calls for m, _, _, calls, B, T, S, H, D in grounding_attention_shapes()
               if m == model and spatial_flash_predicate(batch or B, T, S, H, D))


def grounding_image(seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, GROUNDING_HW + (3,), np.uint8)


def _grounding_launch_row(counts, routes, flash: int) -> dict:
    """The launch counts of a grounding phase: exactly `flash` flash
    forwards, all on "wgmma", and no other kernel of the port."""
    return dict(launches=counts, route_launches=routes, flash_launches_expected=flash,
                launches_ok=counts == dict(dict.fromkeys(KERNELS, 0), flash_fwd=flash)
                and routes["flash_fwd"].get("wgmma", 0) == flash)


def _labelled(fn, label: str):
    """fn inside a torch.profiler.record_function range named `label`."""
    import functools

    import torch

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def _labelled_profile(fn, labels) -> dict:
    """One torch.profiler pass (host and device) over fn(): the device time
    of its kernels, and of the kernels launched inside each labelled range
    (a record_function range), with their shares; the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and e.name not in labels]
    total_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_label = {}
    for label in labels:
        host = [e for e in events if e.name == label and e.device_type != cuda]
        ms = sum(e.device_time_total for e in host) / 1e3
        by_label[label] = dict(ranges=len(host), device_ms=ms,
                               share=ms / total_ms if total_ms else None)
    top = {}
    for e in kernels:
        top.setdefault(e.name, [0.0, 0])
        top[e.name][0] += e.device_time_total / 1e3
        top[e.name][1] += 1
    rank = sorted(top.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(device_ms=total_ms, kernels=len(kernels), labelled=by_label,
                top=[dict(kernel=k[:80], ms=ms, launches=n,
                          share=ms / total_ms if total_ms else None)
                     for k, (ms, n) in rank])


def phase_grounding(dev, smi: str):
    """BOX and MASK at full size through the spider_decoder_infer twin's
    build_default_decoders(tiny=False): Grounding DINO (Swin-T + BERT-base,
    900 queries, 512 px) and SAM ViT-H (1024 px), bf16, random from seed 0.
    Yields the rows grounding, grounding_check, mask, mask_check and
    grounding_profile, each as it is done; the main-path rows (grounding,
    mask) carry their launches."""
    import dataclasses
    import statistics as st

    import torch

    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models import dino as dino_mod
    from spider_tpu_torch.models.dino import GroundingDINO, with_dtype
    from spider_tpu_torch.models.sam import Sam, SamViTBlock, postprocess_masks
    from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer
    from spider_tpu_torch.ops.attention import spatial_flash_config
    from spider_tpu_torch.processors.vision import sam_preprocess
    from spider_tpu_torch.spider_decoder_infer import build_default_decoders

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    decoders = build_default_decoders(tiny=False, with_grounding=True, device=dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dino, mask_fn = decoders["BOX"], decoders["MASK"]
    sam = mask_fn.sam
    image = grounding_image(31)
    dino_flash = grounding_flash_calls("grounding_dino_512px")
    sam_flash = grounding_flash_calls("sam_vit_h_box")

    def finite(t) -> bool:
        return bool(torch.isfinite(t.float()).all())

    # ---- grounding: GroundingDINOInference, the inference_detector contract
    dino(image, GROUNDING_CAPTION)                               # warm-up
    torch.cuda.synchronize()
    secs = []
    reset_launches()
    for _ in range(GROUNDING_CALLS):
        t1 = time.perf_counter()
        res = dino(image, GROUNDING_CAPTION)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    counts, routes = read_launches(), read_route_launches()
    s_call = st.median(secs)
    prof = _device_profile(lambda: dino.raw(image, GROUNDING_CAPTION), s_call, steps=1, top=6)
    launch = _grounding_launch_row(counts, routes, GROUNDING_CALLS * dino_flash)
    yield dict(phase="grounding", model="grounding_dino_tiny: swin-T + bert-base, 900 queries, "
               "6 + 6 layers, 4 levels x 4 points, 256 text tokens", image_size=dino.image_size,
               input_hw=list(GROUNDING_HW), caption=GROUNDING_CAPTION, build_s=build_s,
               calls=GROUNDING_CALLS, s_per_call=s_call, s_per_call_all=secs,
               boxes=len(res["bboxes"]), top_scores=res["scores"][:5],
               flash_launches_per_call=dino_flash,
               device_ms_per_call=prof["device_ms_per_step"],
               device_busy_share=prof["device_busy_share_unprofiled"],
               device_kernels_per_call=prof["device_kernels_per_step"], **launch,
               nvidia_smi=smi,
               ok=launch["launches_ok"] and len(res["bboxes"]) == dino.max_dets
               and all(0.0 <= x <= 1.0 for x in res["scores"])
               and all(b[0] <= b[2] and b[1] <= b[3] for b in res["bboxes"]))

    # ---- grounding_check: raw outputs in bf16 on the kernel and with plain
    # attention, each against an fp32 copy with plain attention
    inputs = dino.inputs(image, GROUNDING_CAPTION)
    ref = GroundingDINO(with_dtype(dino.model.config, torch.float32), dev).eval()
    ref.load_state_dict(dino.model.state_dict())
    flat = lambda o: torch.cat([o["boxes"].float().flatten(), o["scores"].float().flatten()])
    with torch.inference_mode():
        reset_launches()
        routed = dino.model(*inputs)
        check_counts = read_launches()
        with spatial_flash_config("einsum"):
            plain = dino.model(*inputs)
            want = ref(*inputs)
    err_kernel, err_plain = _rel_errors(flat(routed), flat(plain), flat(want))
    # the bf16 routes share the query selection, which bf16 and fp32 make
    # differently: their distance from each other is the kernel's own
    between = _rel_errors(flat(routed), flat(plain), flat(plain))[0]
    yield dict(phase="grounding_check", rel_err_kernel_vs_fp32=err_kernel,
               rel_err_plain_vs_fp32=err_plain, rel_diff_kernel_vs_plain=between,
               flash_launches=check_counts["flash_fwd"], nvidia_smi=smi,
               ok=finite(flat(routed)) and check_counts["flash_fwd"] == dino_flash
               and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)
    del ref, routed, plain, want
    torch.cuda.empty_cache()

    # ---- mask: the twin's MASK decoder behind SpiderDecoderInfer: DINO's top
    # box, rescaled to the SAM frame, prompts SAM ViT-H; the low-res mask back
    # at the original image's size
    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    infer = SpiderDecoderInfer(cfg, decoders=decoders)
    sam_img, sam_hw = sam_preprocess(image, sam.config.img_size)
    samples = dict(llm_text_all=[f"<MASK>{MASK_CAPTION}</MASK>"], Image_ori_array=[image],
                   IMAGE_SAM=[sam_img], Meta_info=dict(original_shape=[GROUNDING_HW],
                                                       sam_shape=[sam_hw]))
    infer(dict(samples))                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    reset_launches()
    for _ in range(GROUNDING_CALLS):
        t1 = time.perf_counter()
        _, preds, texts = infer(dict(samples))
        secs.append(time.perf_counter() - t1)
    counts, routes = read_launches(), read_route_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    low = torch.as_tensor(preds["MASK"][0], device=dev)
    full = postprocess_masks(low[None], sam_hw, GROUNDING_HW, sam.config.img_size)
    img_t = torch.from_numpy(sam_img)[None].to(dev)
    box = torch.tensor([[[60.0, 80.0, 700.0, 600.0]]], device=dev)

    def encode():
        with torch.inference_mode():
            return sam.image_encoder(img_t)

    emb = encode()

    def decode():
        with torch.inference_mode():
            return sam.decode(emb, boxes=box)[0]

    enc_s = st.median(_sync_s(encode)[1] for _ in range(3))
    dec_s = st.median(_sync_s(decode)[1] for _ in range(3))
    launch = _grounding_launch_row(counts, routes,
                                   GROUNDING_CALLS * (dino_flash + sam_flash))
    yield dict(phase="mask", model="sam_vit_h: 32 blocks of 1280, 16 heads, global at "
               "7/15/23/31, windows of 14; the twin's MASK decoder after DINO's top box",
               requests=GROUNDING_CALLS, s_per_request=st.median(secs), s_per_request_all=secs,
               encoder_s=enc_s, decoder_s=dec_s, peak_gb=peak_gb, resident_before_gb=before_gb,
               low_res_shape=list(low.shape), original_size_shape=list(full.shape),
               flash_launches_per_decode=sam_flash, mask_spans=texts["MASK"], **launch,
               nvidia_smi=smi,
               ok=launch["launches_ok"] and finite(low) and tuple(low.shape) == (1, 256, 256)
               and tuple(full.shape) == (1, 1) + GROUNDING_HW and texts["MASK"] == [MASK_CAPTION])

    # ---- mask_check: SAM's box decode in bf16 on the kernel and plain,
    # against an fp32 copy with plain attention
    ref = Sam(dataclasses.replace(sam.config, dtype=torch.float32), dev).eval()
    ref.load_state_dict(sam.state_dict())
    with torch.inference_mode():
        reset_launches()
        routed = sam.predict_box(img_t, box)
        check_counts = read_launches()
        with spatial_flash_config("einsum"):
            plain = sam.predict_box(img_t, box)
            want = ref.predict_box(img_t, box)
    err_kernel, err_plain = _rel_errors(routed.float(), plain.float(), want.float())
    yield dict(phase="mask_check", rel_err_kernel_vs_fp32=err_kernel,
               rel_err_plain_vs_fp32=err_plain, flash_launches=check_counts["flash_fwd"],
               nvidia_smi=smi,
               ok=finite(routed) and check_counts["flash_fwd"] == sam_flash
               and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)
    del ref, routed, plain, want
    torch.cuda.empty_cache()

    # ---- grounding_profile: device time by kernel of one DINO call and one
    # SAM encode, with the deformable attention's and the ViT attention's share
    msda, attend = dino_mod.msda, SamViTBlock.attend
    dino_mod.msda = _labelled(msda, GROUNDING_LABELS[0])
    SamViTBlock.attend = _labelled(attend, GROUNDING_LABELS[1])
    try:
        dino_prof = _labelled_profile(lambda: dino.raw(image, GROUNDING_CAPTION),
                                      GROUNDING_LABELS)
        sam_prof = _labelled_profile(encode, GROUNDING_LABELS)
    finally:
        dino_mod.msda, SamViTBlock.attend = msda, attend
    msda_share = dino_prof["labelled"][GROUNDING_LABELS[0]]["share"]
    vit_share = sam_prof["labelled"][GROUNDING_LABELS[1]]["share"]
    yield dict(phase="grounding_profile", dino_call=dino_prof, sam_encode=sam_prof,
               msda_share_of_dino_call=msda_share, vit_attention_share_of_sam_encode=vit_share,
               nvidia_smi=smi,
               ok=dino_prof["device_ms"] > 0 and sam_prof["device_ms"] > 0
               and msda_share is not None and vit_share is not None
               and dino_prof["labelled"][GROUNDING_LABELS[0]]["ranges"]
               == dino.model.config.enc_layers + dino.model.config.dec_layers)
    del decoders, dino, mask_fn, sam, infer, emb
    torch.cuda.empty_cache()


def checkpoint_grounding(directory: str, dev) -> list:
    """SAM ViT-H (the official release's keys, one fp32 .pth) and Grounding
    DINO Swin-T (mm_grounding_dino's keys, one fp32 .pth), synthetic and in
    their real layouts, loaded with from_pretrained(kind, path=...) in bf16:
    every tensor equal to the on-card conversion of the written ones."""
    import torch

    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models.dino import GroundingDINO, grounding_dino_tiny
    from spider_tpu_torch.models.sam import Sam, sam_vit_h

    rows = []
    for kind, manifest, make, rules_fn, name in (
            ("sam", "sam_vit_h", lambda: Sam(sam_vit_h(), dev), C.sam_rules,
             "sam_vit_h_4b8939.pth"),
            ("grounding_dino", "grounding_dino_swin_t",
             lambda: GroundingDINO(grounding_dino_tiny(), dev), C.grounding_dino_rules,
             "grounding_dino_swin-t.pth")):
        t0 = time.perf_counter()
        module = make()
        keys = manifest_keys(manifest)
        rules = rules_fn(keys, module.config)
        hf = C.export_state_dict(rules, fill_synthetic_(module, CKPT_SEED).state_dict())
        path = os.path.join(directory, name)
        cpu = {k: v.cpu() for k, v in hf.items()}
        torch.save(cpu, path)
        total = sum(t.numel() * t.element_size() for t in cpu.values())
        del module, cpu
        write_s = time.perf_counter() - t0
        got, load = _timed_load(lambda: factory.from_pretrained(kind, path=path, device=dev,
                                                                dtype=torch.bfloat16))
        loaded = got.model if kind == "grounding_dino" else got
        bad = _states_equal(loaded.state_dict(), C.convert_state_dict(rules, hf))
        row = dict(phase="checkpoint", model=kind, checkpoint_gb=total / 1e9, write_s=write_s,
                   read_gb_per_s=total / 1e9 / load["load_s"],
                   keys_equal_manifest=sorted(hf) == sorted(keys), tensors=len(hf),
                   tensors_differing=bad[:8], **load)
        row["ok"] = row["keys_equal_manifest"] and not bad
        rows.append(row)
        del got, loaded, hf
        os.remove(path)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Qwen2.5-Omni: any-modality in, text and speech out (OmniSpeechPipeline)
# ---------------------------------------------------------------------------

OMNI_PROMPT = "Describe <IMAGE-Placeholder> and what you hear in <AUDIO-Placeholder>."
OMNI_IMAGE_HW = (448, 448)            # 32 x 32 patches of 14 -> 256 merged tokens
OMNI_MEL_FRAMES = 1000                # 10 s of 128-bin log-mel -> 250 audio tokens
OMNI_THINKER_TOKENS = 64
OMNI_SPEECH_TOKENS = 127              # decode steps after the first id: up to 128 codes
OMNI_FLOW_STEPS = 10
OMNI_GUIDANCE = 0.5
OMNI_UPSAMPLE = 240                   # BigVGAN's 5 x 3 x 2 x 2 x 2 x 2
OMNI_CKPT_LAYERS = 4                  # the synthetic checkpoint: 4 of 28 LLM and talker
OMNI_CKPT_TOWER_LAYERS = 4            # layers, 4 of 32 tower layers
OMNI_LABELS = ("omni::audio_attention", "omni::vision_attention", "omni::dit_attention")


def omni_inputs(seed: int = 41):
    """The seeded request media: a normalised 448 x 448 RGB image and a 10 s
    128-bin log-mel."""
    import numpy as np

    rng = np.random.default_rng(seed)
    image = rng.standard_normal(OMNI_IMAGE_HW + (3,)).astype(np.float32)
    mel = (rng.standard_normal((OMNI_MEL_FRAMES, 128)) - 4.0).astype(np.float32)
    return image, mel


def omni_prefill_lengths() -> tuple:
    """(thinker prefill T, talker prefill T) of the omni request with
    TinyTokenizer ids: the prompt's text tokens, 256 image tokens (32 x 32
    patches merged 2 x 2), 250 audio tokens (5 chunks of 200 frames, 100
    tokens each after the stride-2 conv, pooled by 2); the talker's is two
    rows longer (the speaker's text-BOS and the first reply row)."""
    import re

    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    tok = TinyTokenizer()
    text = sum(len(tok(p, add_special_tokens=False).input_ids)
               for p in re.split("<IMAGE-Placeholder>|<AUDIO-Placeholder>", OMNI_PROMPT) if p)
    image = (OMNI_IMAGE_HW[0] // 14) * (OMNI_IMAGE_HW[1] // 14) // 4
    audio = sum(((200 - 1) // 2 + 1) for _ in range(OMNI_MEL_FRAMES // 200)) // 2
    T = text + image + audio
    return T, T + 2


class _Timed:
    """A stand-in for `inner` whose calls (and `methods`) are timed to a
    device synchronise, the seconds and calls summed into timing[key]."""

    def __init__(self, inner, timing: dict, key: str):
        self.inner, self.timing, self.key = inner, timing, key

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *args, **kwargs):
        return _timed_call(self.inner, self.timing, self.key, args, kwargs)


def _timed_call(fn, timing: dict, key: str, args, kwargs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    s, n = timing.get(key, (0.0, 0))
    timing[key] = (s + time.perf_counter() - t0, n + 1)
    return out


def _time_methods(obj, names, timing: dict, prefix: str):
    """Wrap obj's bound methods `names` on the instance, timed into timing."""
    for name in names:
        fn = getattr(obj, name)
        setattr(obj, name, lambda *a, _fn=fn, _k=prefix + name, **kw:
                _timed_call(_fn, timing, _k, a, kw))


def phase_omni(dev, smi: str):
    """Qwen2.5-Omni-7B at full width and depth, bf16 (token2wav fp32), random
    from seed 0, built by from_pretrained('omni_speech') and driven through
    OmniSpeechPipeline.chat_with_speech: one request of text, a 448 x 448
    image and 10 s of audio; 64 thinker tokens, up to 128 codec tokens under
    HF's default sampling, token2wav with 10 RK4 steps and guidance 0.5.
    Yields the rows omni (after a warm-up turn), omni_check and omni_profile;
    the omni row carries its launches (28 flash forwards a prefill, the
    thinker's and the talker's, all on "wgmma")."""
    import dataclasses

    import numpy as np
    import torch

    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models import omni_token2wav, qwen_omni
    from spider_tpu_torch.ops.norms import rms_norm

    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    pipe = factory.from_pretrained("omni_speech", device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    thinker, talker = pipe.thinker, pipe.talker
    thinker.max_new_tokens = OMNI_THINKER_TOKENS
    image, mel = omni_inputs()
    T_think, T_talk = omni_prefill_lengths()
    layers = thinker.llm.config.num_hidden_layers + talker.config.num_hidden_layers
    kw = dict(audios=[mel], images=[image], max_speech_tokens=OMNI_SPEECH_TOKENS,
              num_flow_steps=OMNI_FLOW_STEPS, guidance_scale=OMNI_GUIDANCE)

    # the warm-up turn, shorter; then the measured one with each stage timed
    thinker.max_new_tokens = 4
    pipe.chat_with_speech(OMNI_PROMPT, **dict(kw, max_speech_tokens=8, num_flow_steps=2))
    thinker.max_new_tokens = OMNI_THINKER_TOKENS
    timing = {}
    _time_methods(thinker, ("encode_audio", "encode_image", "prefill", "_decode"), timing,
                  "thinker.")
    _time_methods(pipe, ("talk",), timing, "pipe.")
    token2wav = pipe.token2wav
    pipe.token2wav = _Timed(token2wav, timing, "token2wav")
    codes_seen, decoded = [], []
    talk, decode = pipe.talk, thinker._decode
    pipe.talk = lambda *a, **k: codes_seen.append(talk(*a, **k)) or codes_seen[-1]
    thinker._decode = lambda *a, **k: decoded.append(decode(*a, **k)) or decoded[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    text, wav = pipe.chat_with_speech(OMNI_PROMPT, **kw)
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t0
    counts, routes = read_launches(), read_route_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name in ("encode_audio", "encode_image", "prefill", "_decode"):
        del thinker.__dict__[name]
    del pipe.__dict__["talk"]
    pipe.token2wav = token2wav
    codes = codes_seen[-1]
    sec = lambda k: timing[k][0]
    prefill_s = sec("thinker.prefill")
    decode_s = sec("thinker._decode") - prefill_s
    # decode steps: one a reply row (up to 64; the loop stops at EOS)
    steps = len(decoded[-1][2])
    launch_ok = (counts == dict(dict.fromkeys(KERNELS, 0), flash_fwd=layers)
                 and routes["flash_fwd"].get("wgmma", 0) == layers)
    wav_ok = (wav.dtype == np.float32 and wav.ndim == 1 and bool(np.isfinite(wav).all())
              and float(np.abs(wav).max(initial=0.0)) <= 1.0
              and wav.size == 2 * len(codes) * OMNI_UPSAMPLE)
    codes_ok = (1 <= len(codes) <= OMNI_SPEECH_TOKENS + 1
                and int(codes.max()) <= token2wav.dit.config.num_embeds)
    yield dict(phase="omni", model="Qwen2.5-Omni-7B: thinker (qwen2 28 layers of 3584, 28/4 "
               "heads, mrope 16/24/24; audio tower 32 x 1280; vision tower 32 x 1280, full "
               "attention at 7/15/23/31), talker (28 layers of 3584), DiT 22 x 1024, BigVGAN "
               "1536 ch x240", build_s=build_s, resident_gb=resident_gb, peak_gb=peak_gb,
               prompt=OMNI_PROMPT, image_hw=list(OMNI_IMAGE_HW), mel_frames=OMNI_MEL_FRAMES,
               thinker_prefill_T=T_think, talker_prefill_T=T_talk,
               audio_encode_s=sec("thinker.encode_audio"),
               image_encode_s=sec("thinker.encode_image"),
               thinker_prefill_ms=prefill_s * 1e3, thinker_decode_s=decode_s,
               thinker_decode_steps=steps,
               thinker_decode_tok_s=steps / decode_s if decode_s > 0 else None,
               text_chars=len(text), talker_s=sec("pipe.talk"), codes=len(codes),
               talker_tok_s=len(codes) / sec("pipe.talk"), token2wav_s=sec("token2wav"),
               turn_s=turn_s, wave_samples=int(wav.size),
               wave_samples_expected=2 * len(codes) * OMNI_UPSAMPLE,
               wave_abs_max=float(np.abs(wav).max(initial=0.0)), launches=counts,
               route_launches=routes, flash_launches_expected=layers, nvidia_smi=smi,
               ok=launch_ok and wav_ok and codes_ok and isinstance(text, str))

    # ---- omni_check: the thinker's prefill logits in bf16 on the kernel and
    # with plain attention, each against an fp32 copy with plain attention
    # (streamed a layer at a time: the fp32 thinker would not fit beside the
    # resident models)
    llm, cfg = thinker.llm, thinker.llm.config
    embeds, positions, _ = thinker.prepare(OMNI_PROMPT, [mel], [image])
    T = embeds.shape[1]
    pos = torch.from_numpy(positions).to(dev)

    def prefill_logits():
        cache = L.init_kv_cache(cfg, 1, T, device=dev)
        return llm.call_with_final(embeds, positions=pos, kv_write_index=0, kv_cache=cache,
                                   kv_len=torch.tensor([T], dtype=torch.int32, device=dev))[0]

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    with torch.inference_mode():
        reset_launches()
        routed = prefill_logits()[0].float()
        check_counts, check_routes = read_launches(), read_route_launches()
        with plain_llama_attention():
            plain = prefill_logits()[0].float()
            x = embeds.float()
            for layer in llm.model.layers:
                block = L.LlamaBlock(cfg32, dev).eval()
                block.load_state_dict(layer.state_dict())
                x = block(x, pos, 0)[0]
                del block
            final = rms_norm(x, llm.model.norm.float(), cfg.rms_norm_eps)
            want = (final @ llm.lm_head.weight.float().T)[0]
    err_kernel, err_plain = _rel_errors(routed, plain, want)
    agree = float((routed.argmax(-1) == want.argmax(-1)).float().mean())
    yield dict(phase="omni_check", T=T, rel_err_kernel_vs_fp32=err_kernel,
               rel_err_plain_vs_fp32=err_plain, argmax_agree_kernel_vs_fp32=agree,
               flash_launches=check_counts["flash_fwd"],
               flash_wgmma=check_routes["flash_fwd"].get("wgmma", 0), nvidia_smi=smi,
               ok=bool(torch.isfinite(routed).all()) and T == T_think
               and check_counts["flash_fwd"] == cfg.num_hidden_layers
               and check_routes["flash_fwd"].get("wgmma", 0) == cfg.num_hidden_layers
               and err_kernel <= UNET_REL_SLACK * err_plain + 1e-3)
    del routed, plain, want, x, final
    torch.cuda.empty_cache()

    # ---- omni_profile: device time by kernel of the towers' encodes and one
    # thinker prefill, and of one DiT call (CFG batch of 2 over 2 x codes
    # frames), with the share of the towers' and the DiT's plain attention
    saved = (qwen_omni.audio_attention, qwen_omni.vision_attention,
             omni_token2wav.dit_attention)
    qwen_omni.audio_attention = _labelled(saved[0], OMNI_LABELS[0])
    qwen_omni.vision_attention = _labelled(saved[1], OMNI_LABELS[1])
    omni_token2wav.dit_attention = _labelled(saved[2], OMNI_LABELS[2])
    dit, dcfg = token2wav.dit, token2wav.dit.config
    Tm = 2 * len(codes)
    g = torch.Generator(device=dev).manual_seed(5)
    y = torch.randn((1, Tm, dcfg.mel_dim), generator=g, device=dev)
    spk = torch.zeros((1, Tm, dcfg.enc_emb_dim), device=dev)
    ref_mel = torch.zeros((1, 2 * dcfg.block_size, dcfg.mel_dim), device=dev)
    code = torch.as_tensor(codes[None].astype(np.int64), device=dev)

    def thinker_call():
        with torch.inference_mode():
            thinker.encode_audio(mel)
            thinker.encode_image(image)
            thinker.prefill(embeds, positions, 0)

    def dit_call():
        with torch.inference_mode():
            dit(y, spk, ref_mel, code, 0.5, apply_cfg=True)

    try:
        think_prof = _labelled_profile(thinker_call, OMNI_LABELS)
        dit_prof = _labelled_profile(dit_call, OMNI_LABELS)
    finally:
        qwen_omni.audio_attention, qwen_omni.vision_attention, omni_token2wav.dit_attention = \
            saved
    towers = {k: think_prof["labelled"][k] for k in OMNI_LABELS[:2]}
    yield dict(phase="omni_profile", towers_and_prefill=think_prof, dit_call=dit_prof,
               audio_attention_share=towers[OMNI_LABELS[0]]["share"],
               vision_attention_share=towers[OMNI_LABELS[1]]["share"],
               dit_attention_share=dit_prof["labelled"][OMNI_LABELS[2]]["share"],
               dit_frames=Tm, nvidia_smi=smi,
               ok=think_prof["device_ms"] > 0 and dit_prof["device_ms"] > 0
               and towers[OMNI_LABELS[0]]["ranges"] == pipe.thinker.audio_enc.config.num_layers
               and towers[OMNI_LABELS[1]]["ranges"] == pipe.thinker.vision_enc.config.depth
               and dit_prof["labelled"][OMNI_LABELS[2]]["ranges"] == dcfg.num_hidden_layers)
    del pipe, thinker, talker, token2wav, dit, embeds
    torch.cuda.empty_cache()


def _omni_keys(name: str, layers: int, prefix: str):
    """The manifest's keys with `prefix`, cut to the first `layers` of its
    ``layers.N.`` / ``blocks.N.`` entries."""
    import re

    out = []
    for k in manifest_keys(name):
        m = re.match(r"(?:model\.)?(?:layers|blocks)\.(\d+)\.", k)
        if m is None or int(m.group(1)) < layers:
            out.append(prefix + k)
    return out


def checkpoint_omni(directory: str, dev):
    """A synthetic Qwen2.5-Omni-7B checkpoint in the HF layout (bf16 safetensors
    and config.json), at full width and cut in depth only: 4 of 28 LLM and
    talker layers, 4 of 32 layers of each tower; the key lists those of the
    five omni_* manifests at that depth (the DiT and BigVGAN whole) and the
    thinker's Qwen2 decoder. Loaded through from_pretrained('qwen_omni_thinker'
    and 'omni_speech', path=...) with every tensor equal to the on-card
    conversion of the written ones and the thinker's reply equal to one filled
    in memory; then the qwen2_5omni_infer twin through SPIDER_TPU_OMNI=1 and
    SPIDER_TPU_OMNI_CKPT, its answer equal to SpiderFree on the in-memory
    thinker. Returns rows."""
    import dataclasses
    import gc

    import torch

    from spider_tpu_torch import qwen2_5omni_infer
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models import checkpoint_io as io
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models import qwen_omni as Q
    from spider_tpu_torch.models.omni_talker import OmniTalker, talker_full
    from spider_tpu_torch.models.omni_token2wav import BigVGAN, DiTModel, bigvgan_full, dit_full
    from spider_tpu_torch.models.tokenizer import TinyTokenizer
    from spider_tpu_torch.serving.spider_free import SpiderFree

    bf16 = torch.bfloat16
    depths = dict(llm=dict(num_hidden_layers=OMNI_CKPT_LAYERS),
                  audio=dict(num_layers=OMNI_CKPT_TOWER_LAYERS),
                  vision=dict(depth=OMNI_CKPT_TOWER_LAYERS))
    t0 = time.perf_counter()
    acfg, vcfg, lcfg = Q.omni_thinker_configs(bf16, depths)
    tcfg = dataclasses.replace(talker_full(), dtype=bf16, param_dtype=bf16,
                               num_hidden_layers=OMNI_CKPT_LAYERS)
    src = dict(audio=Q.OmniAudioEncoder(acfg, dev), vision=Q.OmniVisionEncoder(vcfg, dev),
               llm=L.LlamaForCausalLM(lcfg, dev), talker=OmniTalker(tcfg, dev),
               dit=DiTModel(dit_full(), dev), vocoder=BigVGAN(bigvgan_full(), dev))
    for i, m in enumerate(src.values()):
        fill_synthetic_(m.eval(), CKPT_SEED + i)
    keys = {"audio": _omni_keys("omni_audio_tower", OMNI_CKPT_TOWER_LAYERS, "thinker.audio_tower."),
            "vision": _omni_keys("omni_vision_tower", OMNI_CKPT_TOWER_LAYERS, "thinker.visual."),
            "talker": _omni_keys("omni_talker", OMNI_CKPT_LAYERS, "talker."),
            "dit": _omni_keys("omni_dit", 99, "token2wav.code2wav_dit_model."),
            "vocoder": _omni_keys("omni_bigvgan", 99, "token2wav.code2wav_bigvgan_model.")}
    all_keys = set().union(*map(set, keys.values()))
    ra, rv, rl = C.omni_thinker_rules(all_keys | {"thinker.lm_head.weight"}, acfg, vcfg, lcfg)
    rules = dict(audio=ra, vision=rv, llm=rl, talker=C.omni_talker_rules(all_keys, tcfg),
                 dit=C.omni_dit_rules(all_keys, dit_full()),
                 vocoder=C.omni_bigvgan_rules(all_keys, bigvgan_full()))
    def free():
        gc.collect()
        torch.cuda.empty_cache()

    hf = {}
    for name, module in src.items():
        hf.update({k: v.to(bf16) for k, v in C.export_state_dict(
            rules[name], module.state_dict()).items()})
    # the two keys the converters skip, present in a real checkpoint
    hf["thinker.audio_tower.audio_bos_eos_token.weight"] = torch.zeros(2, acfg.output_dim,
                                                                       dtype=bf16, device=dev)
    hf["token2wav.code2wav_dit_model.rotary_embed.inv_freq"] = torch.ones(
        dit_full().head_dim // 2, dtype=bf16, device=dev)
    llm_keys = {k for r in rl for k in r.keys}
    keys_ok = set(hf) == all_keys | llm_keys and all(
        set(v) <= set(hf) for v in keys.values())
    io.save_file({k: v.contiguous().cpu() for k, v in hf.items()},
                 os.path.join(directory, "model.safetensors"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen2_5OmniModel"], "model_type": "qwen2_5_omni",
                   "thinker_config": {"text_config": {"num_hidden_layers": OMNI_CKPT_LAYERS},
                                      "audio_config": {"encoder_layers": OMNI_CKPT_TOWER_LAYERS},
                                      "vision_config": {"depth": OMNI_CKPT_TOWER_LAYERS}},
                   "talker_config": {"num_hidden_layers": OMNI_CKPT_LAYERS},
                   "torch_dtype": "bfloat16"}, f, indent=2)
    total = sum(t.numel() * t.element_size() for t in hf.values())
    write_s = time.perf_counter() - t0
    rows = []

    del src
    free()
    image, mel = omni_inputs(43)
    image = image[:224, :224]
    prompt = "Look at <IMAGE-Placeholder> and <AUDIO-Placeholder>."
    # the thinker filled in memory from the same tensors
    parts = []
    for make, rset in ((lambda: Q.OmniAudioEncoder(acfg, dev), ra),
                       (lambda: Q.OmniVisionEncoder(vcfg, dev), rv),
                       (lambda: L.LlamaForCausalLM(lcfg, dev), rl)):
        part = make().eval()
        part.load_state_dict(C.convert_state_dict(rset, hf), strict=True)
        parts.append(part)
    class Ids(TinyTokenizer):
        """TinyTokenizer keeping the ids of its last decode: most of a random
        152064-id model's ids decode to nothing, so the texts alone would
        agree too easily."""

        def decode(self, ids, **kw):
            self.ids = list(ids)
            return super().decode(ids, **kw)

    mem = Q.QwenOmniThinker(parts[2], Ids(), parts[0], parts[1], max_new_tokens=16)
    want_reply = mem.chat(prompt, audios=[mel[:400]], images=[image])
    want_ids = mem.tokenizer.ids
    thinker, load = _timed_load(lambda: factory.from_pretrained(
        "qwen_omni_thinker", path=directory, device=dev, dtype=bf16))
    bad = []
    for mod, rset in ((thinker.audio_enc, ra), (thinker.vision_enc, rv), (thinker.llm, rl)):
        bad += _states_equal(mod.state_dict(), C.convert_state_dict(rset, hf))
    thinker.max_new_tokens = 16
    thinker.tokenizer = Ids()
    reset_launches()
    reply = thinker.chat(prompt, audios=[mel[:400]], images=[image])
    launches, routes = read_launches(), read_route_launches()
    ids_equal = thinker.tokenizer.ids == want_ids and len(want_ids) == 17
    rows.append(dict(phase="checkpoint", model="qwen_omni_thinker", checkpoint_gb=total / 1e9,
                     write_s=write_s, read_gb_per_s=total / 1e9 / load["load_s"],
                     keys_equal_manifests=keys_ok, tensors=len(hf), tensors_differing=bad[:8],
                     depths=depths, reply_equal_in_memory=reply == want_reply,
                     reply_ids_equal_in_memory=ids_equal, reply_ids=len(want_ids),
                     reply_chars=len(reply), launches=launches, route_launches=routes,
                     **load,
                     ok=keys_ok and not bad and reply == want_reply and ids_equal
                     and launches["flash_fwd"] == OMNI_CKPT_LAYERS
                     and routes["flash_fwd"].get("wgmma", 0) == OMNI_CKPT_LAYERS))
    del thinker
    free()

    speech, load = _timed_load(lambda: factory.from_pretrained(
        "omni_speech", path=directory, device=dev, dtype=bf16))
    bad = []
    for mod, name in ((speech.talker, "talker"), (speech.token2wav.dit, "dit"),
                      (speech.token2wav.vocoder, "vocoder")):
        bad += _states_equal(mod.state_dict(), C.convert_state_dict(rules[name], hf))
    rows.append(dict(phase="checkpoint", model="omni_speech", tensors_differing=bad[:8],
                     talker_layers=speech.talker.config.num_hidden_layers,
                     read_gb_per_s=total / 1e9 / load["load_s"], **load,
                     ok=not bad and speech.talker.config.num_hidden_layers == OMNI_CKPT_LAYERS))
    del speech
    free()

    # the infer twin: SpiderFree on the thinker the environment selects
    saved = {k: os.environ.get(k) for k in ("SPIDER_TPU_OMNI", "SPIDER_TPU_OMNI_CKPT",
                                            "QWEN_OMNI_PATH")}
    os.environ.update(SPIDER_TPU_OMNI="1", SPIDER_TPU_OMNI_CKPT=directory)
    os.environ.pop("QWEN_OMNI_PATH", None)
    hf_tokenizer, twin_tok = factory._hf_tokenizer, Ids()
    factory._hf_tokenizer = lambda *a, **k: twin_tok       # the twin's tokenizer, recording
    try:
        reset_launches()
        t0 = time.perf_counter()
        answer = qwen2_5omni_infer.main([R1_PROMPT])
        twin_s = time.perf_counter() - t0
        launches, routes = read_launches(), read_route_launches()
    finally:
        factory._hf_tokenizer = hf_tokenizer
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    free()
    cfg = Config.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    mem.max_new_tokens = 512                   # build_full_omni_thinker's default
    _, answers, _, _ = SpiderFree(cfg, lambda p, **kw: mem.chat(p, **kw), decoders={}).chat(
        R1_PROMPT)
    ids_equal = twin_tok.ids == mem.tokenizer.ids and len(twin_tok.ids) > 1
    rows.append(dict(phase="checkpoint", model="qwen2_5omni_infer_twin", seconds=twin_s,
                     answer_chars=len(answer), answer_equal_in_memory=answer == answers[0],
                     ids=len(twin_tok.ids), ids_equal_in_memory=ids_equal,
                     launches=launches, route_launches=routes,
                     ok=answer == answers[0] and ids_equal
                     and launches["flash_fwd"] == OMNI_CKPT_LAYERS
                     and routes["flash_fwd"].get("wgmma", 0) == OMNI_CKPT_LAYERS))
    del mem, parts, hf
    free()
    return rows


# ---------------------------------------------------------------------------
# phase parallel: the training side of the multi-card code on one card
# ---------------------------------------------------------------------------

PARALLEL_RING = (1, 8192, 32, 8, 128, 4)     # B, T, Hq, Hkv, D (Llama-3-8B), ring size n
PARALLEL_RING_PLAIN_T = 2048                 # the ring against the fp32 plain form
PARALLEL_CONFIG = "train_configs/spider_longctx_train.py"
PARALLEL_STEPS = 2
PARALLEL_LOSS_REL = 2e-3                     # the wrapped runner against the unwrapped one
PARALLEL_MOE_TOKENS = 512


def _ring_inputs(dev, seed: int, B: int, T: int, Hq: int, Hkv: int, D: int, n: int):
    """q, k, v, g [B, T, H, D] bf16 from a seeded generator, and each split
    into the n ranks' blocks of T / n rows."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    full = [torch.randn((B, T, h, D), generator=g, device=dev).to(torch.bfloat16)
            for h in (Hq, Hkv, Hkv, Hq)]
    Tl = T // n
    split = [[x[:, r * Tl:(r + 1) * Tl].contiguous() for r in range(n)] for x in full]
    return full, split


def _bwd_excess(got, want) -> float:
    """max(|got - want| - (BWD_ATOL + BWD_REL |want|)): <= 0 passes."""
    d = (got.float() - want.float()).abs()
    return (d - (BWD_ATOL + BWD_REL * want.float().abs())).max().item()


def parallel_ring_rows(dev, smi: str):
    """The ring's block steps at Llama-3-8B's attention (B 1, T 8192, 32/8
    heads, D 128, bf16, causal), the four ranks of a ring of 4 run as four
    sets of block steps in one process (ops/ring_attention.ring_attention_ranks),
    forward and backward; then each rank's steps timed on the device. Returns
    (rows, launches of the ring runs)."""
    import torch
    import torch.nn.functional as F

    from spider_tpu_torch.ops import attention as A
    from spider_tpu_torch.ops import ring_attention as R

    B, T, Hq, Hkv, D, n = PARALLEL_RING
    Tl = T // n
    (q, k, v, g), (qs, ks, vs, gs) = _ring_inputs(dev, 51, B, T, Hq, Hkv, D, n)
    rows = []

    # the single call over T 8192 and its backward: the yardstick (not counted)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out_ref, lse_ref = A.flash_attention_with_lse(qr, kr, vr, causal=True)
    out_ref.backward(g)
    torch.cuda.synchronize()

    reset_launches()
    outs, lses, dqs, dks, dvs = R.ring_attention_ranks(qs, ks, vs, gs, causal=True)
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_route_launches()
    again = R.ring_attention_ranks(qs, ks, vs, gs, causal=True)
    same_bits = all(torch.equal(a, b) for xs, ys in zip((outs, lses, dqs, dks, dvs), again)
                    for a, b in zip(xs, ys))
    del again
    cat = lambda xs: torch.cat(xs, dim=1)
    out_err = (cat(outs).float() - out_ref.float()).abs().max().item()
    lse_err = (torch.cat(lses, dim=2) - lse_ref).abs().max().item()
    grad_excess = {name: _bwd_excess(cat(got), want.grad) for name, got, want in
                   (("dq", dqs, qr), ("dk", dks, kr), ("dv", dvs, vr))}
    want_launches = dict(flash_fwd=n * n, flash_bwd_dq=n * n, flash_bwd_dkv=n * n)
    ok = (out_err <= OUT_ATOL and lse_err <= LSE_ATOL and max(grad_excess.values()) <= 0
          and same_bits and all(launches[k] == v for k, v in want_launches.items())
          and all(routes[k]["mma"] == 0 and routes[k]["wgmma"] == v
                  for k, v in want_launches.items()))
    rows.append(dict(phase="parallel", part="ring_8b", B=B, T=T, heads=[Hq, Hkv], D=D, ring=n,
                     out_max_abs_err=out_err, lse_max_abs_err=lse_err,
                     grad_excess=grad_excess, same_bits_twice=same_bits, launches=launches,
                     route_launches=routes, ok=ok, nvidia_smi=smi))

    # a fully masked block leaves the merge bit-unchanged (rank 0's block from
    # rank n - 1, after its diagonal step)
    o0, l0 = R.ring_step_forward(qs[0], ks[0], vs[0], *R._initial(qs[0]), 0)
    o1, l1 = R.ring_step_forward(qs[0], ks[n - 1], vs[n - 1], o0, l0, -(n - 1) * Tl)
    dead_ok = torch.equal(o0, o1) and torch.equal(l0, l1)

    # each block kind on the kernel against the plain form (live rows): past,
    # diagonal, after the diagonal
    offsets = {}
    for rel in (Tl, 0, -Tl):
        o, lse = R.ring_block(qs[1], ks[0], vs[0], rel, True)
        po, plse = A.mha_reference_with_lse(qs[1].float(), ks[0].float(), vs[0].float(),
                                            causal=True, q_offset=rel)
        live = torch.isfinite(plse)
        rows_live = live.transpose(1, 2)[..., None].expand_as(o)
        offsets[str(rel)] = dict(
            live_rows=int(live.sum()),
            out_max_abs_err=(o.float() - po)[rows_live].abs().max().item() if live.any() else 0.0,
            lse_max_abs_err=(lse - plse)[live].abs().max().item() if live.any() else 0.0)
    offsets_ok = all(v["out_max_abs_err"] <= OUT_ATOL and v["lse_max_abs_err"] <= LSE_ATOL
                     for v in offsets.values()) and offsets[str(-Tl)]["live_rows"] == 0
    rows.append(dict(phase="parallel", part="ring_blocks", dead_block_merge_unchanged=dead_ok,
                     offsets=offsets, ok=dead_ok and offsets_ok, nvidia_smi=smi))

    # against the fp32 plain form at T 2048, n 4
    Tp = PARALLEL_RING_PLAIN_T
    (q2, k2, v2, g2), (q2s, k2s, v2s, g2s) = _ring_inputs(dev, 52, B, Tp, Hq, Hkv, D, n)
    o2, l2, dq2, dk2, dv2 = R.ring_attention_ranks(q2s, k2s, v2s, g2s, causal=True)
    pq, pk, pv = (x.float().requires_grad_(True) for x in (q2, k2, v2))
    po, plse = A.mha_reference_with_lse(pq, pk, pv, causal=True)
    po.backward(g2.float())
    plain_excess = {name: _bwd_excess(cat(got), want.grad) for name, got, want in
                    (("dq", dq2, pq), ("dk", dk2, pk), ("dv", dv2, pv))}
    plain = dict(out_max_abs_err=(cat(o2).float() - po).abs().max().item(),
                 lse_max_abs_err=(torch.cat(l2, dim=2) - plse).abs().max().item(),
                 grad_excess=plain_excess)
    del pq, pk, pv, po, plse
    plain_ok = (plain["out_max_abs_err"] <= OUT_ATOL and plain["lse_max_abs_err"] <= LSE_ATOL
                and max(plain_excess.values()) <= 0)
    rows.append(dict(phase="parallel", part="ring_vs_fp32_plain", T=Tp, ring=n, **plain,
                     ok=plain_ok, nvidia_smi=smi))

    # device time: each rank's steps, the single call, SDPA, the bound
    delta = [R.ring_delta(o, x) for o, x in zip(outs, gs)]

    def fwd(my):
        o_run, lse_run = R._initial(qs[my])
        for i in range(n):
            src = (my - i) % n
            o_run, lse_run = R.ring_step_forward(qs[my], ks[src], vs[src], o_run, lse_run,
                                                 (my - src) * Tl)

    def bwd(my):
        for i in range(n):
            src = (my - i) % n
            R.ring_step_backward(qs[my], ks[src], vs[src], outs[my], lses[my], delta[my],
                                 gs[my], (my - src) * Tl)

    fwd_ms = [device_ms(lambda my=my: fwd(my), calls=5) for my in range(n)]
    bwd_ms = [device_ms(lambda my=my: bwd(my), calls=5) for my in range(n)]
    single_fwd = device_ms(lambda: A.flash_attention_with_lse(q, k, v, causal=True), calls=5)
    ref_delta = A._delta(g, out_ref.detach(), None)
    live_full, off_full = A._live_and_offset(B, T, T, None, None, dev)
    single_bwd = device_ms(lambda: (A.flash_bwd_dq(q, k, v, g, lse_ref, ref_delta, live_full,
                                                   off_full, True, None),
                                    A.flash_bwd_dkv(q, k, v, g, lse_ref, ref_delta, live_full,
                                                    off_full, True, None)), calls=5)
    (sq, sk, sv), kw, _ = sdpa_call(q, k, v, dict(causal=True))
    sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, **kw), calls=5)
    sq2, sk2, sv2 = (x.detach().clone().requires_grad_(True) for x in (sq, sk, sv))
    sdpa_out = F.scaled_dot_product_attention(sq2, sk2, sv2, **kw)
    gh = g.transpose(1, 2)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(sdpa_out, (sq2, sk2, sv2), gh,
                                                     retain_graph=True), calls=5)
    pairs = live_pairs(B, T, T, True)
    flops = 4.0 * pairs * Hq * D
    io = 2.0 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D) + 4.0 * B * Hq * T
    fbound, bbound = bound_ms(io, flops), bound_ms(2 * io, 2.5 * flops)
    diag_gflop = 4.0 * B * Hq * D * Tl * (Tl + 1) / 2 / 1e9
    past_gflop = 4.0 * B * Hq * D * Tl * Tl / 1e9
    rows.append(dict(
        phase="parallel", part="ring_time", fwd_device_ms_per_rank=fwd_ms,
        bwd_device_ms_per_rank=bwd_ms, fwd_device_ms_total=sum(fwd_ms),
        bwd_device_ms_total=sum(bwd_ms), single_call_fwd_device_ms=single_fwd,
        single_call_bwd_device_ms=single_bwd, sdpa_fwd_device_ms=sdpa_fwd,
        sdpa_bwd_device_ms=sdpa_bwd, fwd_bound_ms=fbound["bound_ms"],
        fwd_bound_by=fbound["bound_by"], bwd_bound_ms=bbound["bound_ms"],
        fwd_gflop=flops / 1e9, diagonal_block_gflop=diag_gflop, past_block_gflop=past_gflop,
        live_blocks_per_rank=[0.5 + my for my in range(n)], ok=True, nvidia_smi=smi))
    del outs, lses, dqs, dks, dvs, qr, kr, vr, out_ref, lse_ref
    torch.cuda.empty_cache()
    return rows, launches


def parallel_world_of_one_rows(dev, mesh, smi: str):
    """ring_attention, moe_ffn_expert_parallel and gpipe through the NCCL
    world of one: each the bits of its one-device form."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.ops.ring_attention import ring_attention
    from spider_tpu_torch.parallel.collectives import group_of
    from spider_tpu_torch.parallel.moe import (MoEConfig, init_moe_params,
                                               moe_ffn_expert_parallel, moe_ffn_local)
    from spider_tpu_torch.parallel.pipeline import gpipe

    B, _, Hq, Hkv, D, _ = PARALLEL_RING
    (q, k, v, g), _ = _ring_inputs(dev, 53, B, PARALLEL_RING_PLAIN_T, Hq, Hkv, D, 1)
    grads = []
    for fn in (lambda a, b, c: ring_attention(a, b, c, group_of(mesh, (dist.AXIS_CONTEXT,))),
               lambda a, b, c: flash_attention(a, b, c, causal=True)):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        grads.append([out.detach()] + [x.grad for x in leaves])
    ring_same = all(torch.equal(a, b) for a, b in zip(*grads))

    cfg8 = L.llama3_8b()
    mcfg = MoEConfig(num_experts=MOE_EXPERTS, d_model=cfg8.hidden_size,
                     d_ff=cfg8.intermediate_size, capacity_factor=2.0, dtype=torch.bfloat16)
    params = init_moe_params(mcfg, torch.Generator(device=dev).manual_seed(54), device=dev)
    x = torch.randn((PARALLEL_MOE_TOKENS, cfg8.hidden_size),
                    generator=torch.Generator(device=dev).manual_seed(55),
                    device=dev).to(torch.bfloat16)
    ep_out, ep_aux = moe_ffn_expert_parallel(params, x, mcfg,
                                             group_of(mesh, (dist.AXIS_EXPERT,)))
    loc_out, loc_aux = moe_ffn_local(params, x, mcfg)
    ep_same = torch.equal(ep_out, loc_out) and torch.equal(ep_aux, loc_aux)

    w = params["w1"][0]                      # [4096, 14336]: a stage maps h -> gelu(h w) w^T
    stage = lambda p, h: F.gelu(h @ p, approximate="tanh") @ p.T
    mbs = x.reshape(4, PARALLEL_MOE_TOKENS // 4, cfg8.hidden_size)
    pipe_out = gpipe(stage, w, mbs, group_of(mesh, (dist.AXIS_MODEL,)))
    pipe_same = torch.equal(pipe_out, torch.stack([stage(w, mbs[i]) for i in range(4)]))
    del params, x, ep_out, loc_out, pipe_out, w, grads
    torch.cuda.empty_cache()
    return [dict(phase="parallel", part="world_of_one", ring_equals_flash_attention=ring_same,
                 expert_parallel_equals_local=ep_same, gpipe_equals_stage=pipe_same,
                 moe=dict(tokens=PARALLEL_MOE_TOKENS, experts=MOE_EXPERTS,
                          d_model=cfg8.hidden_size, d_ff=cfg8.intermediate_size),
                 ok=ring_same and ep_same and pipe_same, nvidia_smi=smi)]


PARALLEL_INT4_LAYERS = 4                     # of llama3_8b's 32 (the TP row's int4 model)
PARALLEL_INT4_TOKENS = 16


def parallel_moe_rows(dev, mesh, smi: str):
    """The MoE Llama (llama3_8b widths, MOE_LAYERS layers, MOE_EXPERTS experts,
    top-2) through shard_model over the world of one, against the same model
    unsharded: a forward at [4, 512] (logits, aux terms) and one
    make_lm_train_step (loss, aux within PARALLEL_LOSS_REL); the sharded model's
    MoE layers gate through parallel.moe.moe_ffn_sharded. Returns (rows,
    launches of the sharded run)."""
    import dataclasses
    import gc

    import torch

    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.runners import train_step as TS

    cfg = dataclasses.replace(L.llama3_8b(), num_hidden_layers=MOE_LAYERS,
                              num_experts=MOE_EXPERTS, moe_top_k=2)
    B, T = TRAIN_LM_SHAPE
    g = torch.Generator(device=dev).manual_seed(56)
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=dev)
    labels = ids.clone()
    labels[:, : T // 4] = -100
    got = {}
    for name in ("unsharded", "sharded"):
        model = factory.build_llama(cfg, dev, seed=57)
        for p in (model.embed_tokens.weight, model.lm_head.weight):
            p.requires_grad_(False)
        if name == "sharded":
            TS.shard_model(model, mesh)
        reset_launches()
        with torch.no_grad():          # FSDP2's unsharded storage must not be an inference tensor
            logits = model(input_ids=ids)[0].float()
        aux = model.moe_aux_losses().tolist()
        opt = TS.build_optimizer(3e-4, params={n: p for n, p in model.named_parameters()
                                               if p.requires_grad}, weight_decay=0.01)
        model.train()
        metrics, seconds = _sync_s(lambda: TS.make_lm_train_step(model, opt)(
            dict(input_ids=ids, labels=labels)))
        got[name] = dict(logits=logits, aux=aux, seconds=seconds, launches=read_launches(),
                         routes=read_route_launches(),
                         metrics={k: float(v) for k, v in metrics.items()},
                         gated_over_mesh=model.model.layers[0].mlp.mesh is not None)
        del model, opt, logits
        gc.collect()
        torch.cuda.empty_cache()
    a, b = got["sharded"], got["unsharded"]
    rel = lambda x, y: abs(x - y) / max(abs(y), 1e-6)
    loss_rel = max(rel(a["metrics"][k], b["metrics"][k]) for k in ("loss", "moe_aux"))
    aux_rel = max(rel(x, y) for x, y in zip(a["aux"], b["aux"]))
    logit_diff = (a["logits"] - b["logits"]).abs().max().item()
    want = dict(flash_fwd=2 * MOE_LAYERS, flash_bwd_dq=MOE_LAYERS, flash_bwd_dkv=MOE_LAYERS,
                tattn_fwd=0, paged_decode=0, int4_matmul=0, group_norm=0)
    row = dict(phase="parallel", part="moe_llama_world_of_one",
               model=f"llama3_8b widths, {MOE_LAYERS} of 32 layers (cut), {MOE_EXPERTS} "
               "experts, top-2", batch=B, seq_len=T, aux_sharded=a["aux"], aux_unsharded=b["aux"],
               aux_rel=aux_rel, logits_max_abs_diff=logit_diff,
               metrics_sharded=a["metrics"], metrics_unsharded=b["metrics"],
               loss_aux_rel=loss_rel, step_s_sharded=a["seconds"], step_s_unsharded=b["seconds"],
               gated_over_mesh=a["gated_over_mesh"], launches=a["launches"],
               launches_expected=want, route_launches=a["routes"],
               bounds=dict(loss_rel=PARALLEL_LOSS_REL, logits_atol=LOGIT_ATOL), nvidia_smi=smi,
               ok=a["gated_over_mesh"] and loss_rel <= PARALLEL_LOSS_REL
               and aux_rel <= PARALLEL_LOSS_REL and logit_diff <= LOGIT_ATOL
               and a["launches"] == want == b["launches"] and on_ruled_route(a["routes"]))
    return [row], a["launches"]


def parallel_int4_row(dev, mesh, smi: str):
    """The int4 Llama (llama3_8b widths, PARALLEL_INT4_LAYERS layers) through
    partition.parallelize_llama over the world of one's model axis: greedy
    tokens after a 128-token prompt equal to the unwrapped model's, int4
    launches by route equal. Returns (row, launches of the parallel run)."""
    import dataclasses
    import gc

    import torch

    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import factory
    from spider_tpu_torch.parallel import partition

    cfg = dataclasses.replace(factory.llama3_8b_quantized("int4"),
                              num_hidden_layers=PARALLEL_INT4_LAYERS)
    model = factory.build_llama(cfg, dev, seed=58)
    g = torch.Generator(device=dev).manual_seed(59)
    ids = torch.randint(3, cfg.vocab_size, (1, PROMPT_TOKENS), generator=g, device=dev)
    got = {}
    for name in ("unwrapped", "parallel"):
        if name == "parallel":
            partition.parallelize_llama(model, mesh[dist.AXIS_MODEL])
        reset_launches()
        tokens, seconds = _sync_s(lambda: _greedy(model, ids, PARALLEL_INT4_TOKENS))
        got[name] = dict(tokens=tokens, seconds=seconds, launches=read_launches(),
                         routes=read_route_launches())
    a, b = got["parallel"], got["unwrapped"]
    row = dict(phase="parallel", part="int4_tensor_parallel_world_of_one",
               model=f"llama3_8b int4, {PARALLEL_INT4_LAYERS} of 32 layers (cut)",
               prompt_tokens=PROMPT_TOKENS, new_tokens=PARALLEL_INT4_TOKENS,
               tokens_equal=a["tokens"] == b["tokens"], seconds_parallel=a["seconds"],
               seconds_unwrapped=b["seconds"], launches=a["launches"],
               route_launches=a["routes"], route_launches_unwrapped=b["routes"], nvidia_smi=smi,
               ok=a["tokens"] == b["tokens"] and a["routes"] == b["routes"]
               and a["launches"]["int4_matmul"] > 0)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row, a["launches"]


def parallel_config(out_dir: str, mesh):
    """train_configs/spider_longctx_train.py with model.preset=full: its
    datasets at ImageBind-huge's 224 px, run.mesh as given (None: as the
    file writes it; {}: none)."""
    from spider_tpu_torch.common.config import Config, apply_overrides

    opts = ["model.preset='full'", f"run.output_dir='{out_dir}'",
            f"run.iters_per_epoch={PARALLEL_STEPS}", "model.with_pipes=False"]
    opts += [f"datasets.{name}.build_info.image_size={TRAIN_IMAGE_SIZE}"
             for name in ("i2t_cc_sbu", "t2i_ts_cc_sbu")]
    if mesh is not None:
        opts.append(f"run.mesh={mesh!r}")
    return apply_overrides(Config.fromfile(os.path.join(ROOT, PARALLEL_CONFIG)), opts)


def parallel_runner_steps(dev, out_dir: str, mesh, smi: str):
    """PARALLEL_STEPS train_steps of the train entry's build_runner on the
    config; (row, losses, launches)."""
    import gc

    import torch

    from spider_tpu_torch import train as ttrain

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = ttrain.build_runner(parallel_config(out_dir, mesh), dev, "parallel")
    build_s = time.perf_counter() - t0
    loader = runner.dataloaders["train"]
    batches = [next(loader) for _ in range(PARALLEL_STEPS)]
    reset_launches()
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(runner.train_step(b))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches, routes = read_launches(), read_route_launches()
    wrapped = runner.mesh is not None
    row = dict(phase="parallel", part="runner_wrapped" if wrapped else "runner_unwrapped",
               mesh=None if runner.mesh is None else dict(zip(runner.mesh.mesh_dim_names,
                                                              runner.mesh.mesh.shape)),
               fsdp=wrapped and hasattr(runner.model.llm.model.layers[0], "unshard"),
               build_s=build_s, step_s=step_s, losses=losses,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               tasks=[b["TaskPrompt"][0] for b in batches], launches=launches,
               route_launches=routes, nvidia_smi=smi)
    row["ok"] = (all(all(v == v and abs(v) < float("inf") for v in l.values()) for l in losses)
                 and on_ruled_route(routes) and launches["flash_fwd"] > 0
                 and (row["fsdp"] or not wrapped))
    del runner, loader, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row, losses, launches


def phase_parallel(dev, smi: str):
    """The training side of the multi-card code on one card: the NCCL
    bootstrap at a world of one, the ring at 8B width (four ranks' block steps
    in one process), ring attention / EP / GPipe through the world of one, and
    the sharded runner (spider_longctx_train.py, preset full) against the
    unwrapped one. Returns (rows, main-path launches)."""
    import tempfile

    import torch

    from spider_tpu_torch import train as ttrain
    from spider_tpu_torch.common import dist

    rows = []
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    device = dist.init_distributed_mode(dev)           # raises where NCCL does not start
    mesh = dist.make_mesh()
    boot_ok = (torch.distributed.get_backend() == "nccl" and mesh.device_type == "cuda"
               and mesh.mesh_dim_names == dist.AXES and tuple(mesh.mesh.shape) == (1,) * 5
               and device == dev)
    rows.append(dict(phase="parallel", part="bootstrap", backend=torch.distributed.get_backend(),
                     device_type=mesh.device_type, axes=list(mesh.mesh_dim_names),
                     shape=list(mesh.mesh.shape), seconds=time.perf_counter() - t0,
                     ok=boot_ok, nvidia_smi=smi))
    ring_rows, launches = parallel_ring_rows(dev, smi)
    rows += ring_rows
    _add_launches(total, launches)
    rows += parallel_world_of_one_rows(dev, mesh, smi)
    moe_rows, launches = parallel_moe_rows(dev, mesh, smi)
    rows += moe_rows
    _add_launches(total, launches)
    int4_row, launches = parallel_int4_row(dev, mesh, smi)
    rows.append(int4_row)
    _add_launches(total, launches)

    with tempfile.TemporaryDirectory(prefix="spider_parallel_") as d:
        try:                                # as the file writes it: data 2 x context 4
            ttrain.build_runner(parallel_config(d, None), dev, "parallel")
            refused = None
        except ValueError as e:
            refused = str(e)
        rows.append(dict(phase="parallel", part="mesh_refused", mesh=dict(data=2, context=4),
                         error=refused, ok=refused is not None and "rank count 1" in refused,
                         nvidia_smi=smi))
        ones = {a: 1 for a in dist.AXES}
        wrapped, wrapped_losses, launches = parallel_runner_steps(dev, d, ones, smi)
        _add_launches(total, launches)
        dist.destroy()                      # the unwrapped runner needs no process group
        plain, plain_losses, launches = parallel_runner_steps(dev, d, {}, smi)
        _add_launches(total, launches)
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
              for a, b in zip(wrapped_losses, plain_losses) for k in b if k.endswith("loss"))
    wrapped["loss_rel_to_unwrapped"] = rel
    wrapped["ok"] = wrapped["ok"] and rel <= PARALLEL_LOSS_REL and \
        set(wrapped_losses[0]) == set(plain_losses[0])
    rows += [wrapped, plain]
    rows.append(dict(phase="parallel", part="total", seconds=time.perf_counter() - t0,
                     launches=total, ok=all(r["ok"] for r in rows), nvidia_smi=smi))
    return rows, total


def build_report(cuda_build) -> dict:
    """What ptxas said of each library built or found by this process, from
    the log kept beside it: spilled bytes over all kernels, and whether it
    serialised a wgmma (warning C7510: the kernel runs, but slowly)."""
    report = {}
    for name in SOURCES:
        path = cuda_build.build(name)[:-3] + ".log"        # built already: returns its path
        with open(path) as f:
            log = f.read()
        spills = [int(line.split(" bytes spill stores")[0].rsplit(" ", 1)[-1])
                  for line in log.splitlines() if " bytes spill stores" in line]
        report[name] = dict(kernels=len(spills), spill_store_bytes=sum(spills),
                            wgmma_serialized="C7510" in log)
    return report


def phase_floors(rows, spider_free_T: int) -> dict:
    """The redesigned routes against the routes they replaced on the main
    paths, on device time from the `kernel` rows of this run. wgmma over
    mma.sync: the forward at least 2x faster at SD level 0, the long prefill
    and the train shape, and no slower (within NO_SLOWER of timing noise) on
    the three launch-bound shapes; dk/dv at least 1.5x faster at the train
    shape and 2x at B 1, T 2048; dq at least 2x at both, no slower at
    [4, 128], the padded `kv_len` row and the `g_lse` row. The temporal ring
    form over the synchronous one: at least 1.5x at ZeroScope level 0 and at
    most TATTN_L0_MS there, no slower on its other rows. The paged split
    form over the first one: at least 2x at the serving shape and 4x at the
    chat's one long slot. The int4 stream form over the first kernel: no
    slower at 1 and at 16 rows on every projection the rule sends it (down
    stays on the first kernel, a ratio of 1); the 1.3x this form was to reach
    at 16 rows is among the `targets`, which are reported, not gated. The int4
    wgmma form: at least 2x on gate/up and down at 128 and at 1024 rows."""
    B, T = TRAIN_LM_SHAPE
    table = {kernel: {r["name"]: r for r in rows if r["kernel"] == kernel}
             for kernel in ROUTED}
    fwd, dq, dkv, tattn, paged, int4 = (table[k] for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "tattn_fwd", "paged_decode",
        "int4_matmul"))
    small = f"train_B{TRAIN_BATCH}_T{2 * TRAIN_BUCKET}"
    wanted = [(fwd, "unet_self_T4096_D40", 2.0), (fwd, f"prefill_T{spider_free_T}", 2.0),
              (fwd, f"train_B{B}_T{T}", 2.0), (fwd, small, 1.0 / NO_SLOWER),
              (fwd, "unet_cross_T4096_S77_D40", 1.0 / NO_SLOWER),
              (fwd, "audioldm_cross_T8192_S1_D16", 1.0 / NO_SLOWER),
              (dkv, f"train_B{B}_T{T}", 1.5), (dkv, "long_B1_T2048", 2.0),
              (dq, f"train_B{B}_T{T}", 2.0), (dq, "long_B1_T2048", 2.0),
              (dq, small, 1.0 / NO_SLOWER), (dq, "padded_prefill_kv_len", 1.0 / NO_SLOWER),
              (dq, "with_g_lse", 1.0 / NO_SLOWER), (tattn, "zeroscope_L0_D40", 1.5)]
    wanted += [(tattn, name, 1.0 / NO_SLOWER) for name in tattn if name != "zeroscope_L0_D40"]
    wanted += [(paged, "serving_B16_MP4", 2.0), (paged, "chat_B1_MP14_len1758", 4.0)]
    wanted += [(int4, f"{n}_M{M}", 1.0 / NO_SLOWER) for M in (1, 16) for n in INT4_SHAPES]
    wanted += [(int4, f"{n}_M{M}", 2.0) for M in (128, 1024) for n in ("gate_up", "down")]
    checks = [dict(kernel=rows_of[name]["kernel"], shape=name, floor=floor,
                   speedup_device=rows_of[name]["speedup_device"],
                   device_ms=rows_of[name]["device_ms"],
                   previous_device_ms=rows_of[name]["previous_device_ms"],
                   ok=rows_of[name]["speedup_device"] >= floor)
              for rows_of, name, floor in wanted]
    level0 = tattn["zeroscope_L0_D40"]["device_ms"]
    checks.append(dict(kernel="tattn_fwd", shape="zeroscope_L0_D40", ceiling_ms=TATTN_L0_MS,
                       device_ms=level0, ok=level0 <= TATTN_L0_MS))
    targets = [dict(kernel="int4_matmul", shape=f"{n}_M16", what="speedup over the first kernel",
                    target=1.3, got=int4[f"{n}_M16"]["speedup_device"])
               for n in ("q_o", "k_v", "gate_up", "down")]
    targets += [
        dict(kernel="int4_matmul", shape="gate_up_M16", what="share of the byte bound",
             target=0.6, got=int4["gate_up_M16"]["share_of_bound"]),
        dict(kernel="int4_matmul", shape="gate_up_M1024", what="TFLOP/s", target=400.0,
             got=int4["gate_up_M1024"]["tflop_per_s"]),
        dict(kernel="paged_decode", shape="serving_B16_MP4", what="device ms at most",
             target=0.02, got=paged["serving_B16_MP4"]["device_ms"])]
    for tgt in targets:
        tgt["met"] = (tgt["got"] <= tgt["target"] if "at most" in tgt["what"]
                      else tgt["got"] >= tgt["target"])
    return dict(phase="floors", checks=checks, targets=targets,
                ok=all(c["ok"] for c in checks))


def main() -> int:
    started = time.perf_counter()
    kernels_only = sys.argv[1:] == ["kernels"]
    checkpoint_only = sys.argv[1:] == ["checkpoint"]
    family_only = sys.argv[1:] == ["family"]
    story_only = sys.argv[1:] == ["story"]
    grounding_only = sys.argv[1:] == ["grounding"]
    omni_only = sys.argv[1:] == ["omni"]
    data_only = sys.argv[1:] == ["data"]
    parallel_only = sys.argv[1:] == ["parallel"]
    video_sharded_only = sys.argv[1:] == ["video_sharded"]
    if sys.argv[1:] and not (kernels_only or checkpoint_only or family_only or story_only
                             or grounding_only or omni_only or data_only or parallel_only
                             or video_sharded_only):
        print("usage: chip_smoke.py [kernels | checkpoint | family | story | grounding | omni"
              " | data | parallel | video_sharded]", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Nothing here may reach a network: a checkpoint directory without
    # tokenizer files must not send transformers (where installed) to a hub.
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
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
    cuda_build.load_all(SOURCES)
    nvcc_seconds = {k: cuda_build.BUILD_SECONDS.get(k, 0.0) for k in SOURCES}
    # The two serving sources hold three and two kernels: neither may take
    # nvcc longer than flash_bwd.cu with its 72.
    build_ok = max(nvcc_seconds["int4_matmul"], nvcc_seconds["paged_decode"]) <= max(
        nvcc_seconds["flash_bwd"], 1e-9) or nvcc_seconds["flash_bwd"] == 0.0
    emit(dict(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=nvcc_seconds,
              ptxas=build_report(cuda_build), ok=build_ok,
              nvidia_smi=smi, tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))
    ok &= build_ok
    check = phase_wgmma_probe(dev)
    emit(check)
    ok &= check["ok"]

    from spider_tpu_torch.models import factory
    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    if checkpoint_only:
        ok &= phase_checkpoint(dev, smi)[0]
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a checkpoint row failed (see the JSON lines above)",
                  file=sys.stderr)
        return 0 if ok else 1

    if story_only:
        checks = phase_unet_routing(dev) + phase_story_bank_routing(dev) + [phase_tattn_grad(dev)]
        for check in checks:
            emit(dict(nvidia_smi=smi, **check))
            ok &= check["ok"]
        model, tokenizer = factory.from_pretrained("llama", device=dev, seed=0)
        for row in phase_story(model, tokenizer, dev, smi):
            emit(row)
            ok &= row["ok"]
        emit(dict(phase="total", seconds=time.perf_counter() - started))
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a story row failed (see the JSON lines above)", file=sys.stderr)
        return 0 if ok else 1

    if grounding_only:
        for row in phase_kernel_flash_bwd(dev, prefix="sam_"):
            emit(dict(phase="kernel", nvidia_smi=smi, **row))
            ok &= row["ok"]
        for check in phase_unet_routing(dev):
            emit(dict(nvidia_smi=smi, **check))
            ok &= check["ok"]
        for row in phase_grounding(dev, smi):
            emit(row)
            ok &= row["ok"]
        check = phase_mask_step(dev, smi)
        emit(check)
        ok &= check["ok"]
        torch.cuda.empty_cache()
        import tempfile

        with tempfile.TemporaryDirectory(prefix="spider_ckpt_") as d:
            for row in checkpoint_grounding(d, dev):
                emit(dict(row, nvidia_smi=smi))
                ok &= row["ok"]
        emit(dict(phase="total", seconds=time.perf_counter() - started))
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a grounding row failed (see the JSON lines above)",
                  file=sys.stderr)
        return 0 if ok else 1

    if omni_only:
        for row in phase_kernel_flash(dev, 0, only="omni_"):
            emit(dict(phase="kernel", nvidia_smi=smi, **row))
            ok &= row["ok"]
        for row in phase_omni(dev, smi):
            emit(row)
            ok &= row["ok"]
        import tempfile

        with tempfile.TemporaryDirectory(prefix="spider_ckpt_") as d:
            for row in checkpoint_omni(d, dev):
                emit(dict(row, nvidia_smi=smi))
                ok &= row["ok"]
        emit(dict(phase="total", seconds=time.perf_counter() - started))
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: an omni row failed (see the JSON lines above)", file=sys.stderr)
        return 0 if ok else 1

    if data_only:
        sd = factory.from_pretrained("sd15", device=dev, dtype=torch.bfloat16, seed=0)
        vd = factory.from_pretrained("zeroscope", device=dev, dtype=torch.bfloat16, seed=1)
        ad = factory.from_pretrained("audioldm", device=dev, dtype=torch.bfloat16, seed=2)
        for row in phase_train_data(sd, ad, vd, dev, smi)[0]:
            emit(row)
            ok &= row["ok"]
        emit(dict(phase="total", seconds=time.perf_counter() - started))
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a train_data row failed (see the JSON lines above)",
                  file=sys.stderr)
        return 0 if ok else 1

    if video_sharded_only:
        vd = factory.from_pretrained("zeroscope", device=dev, dtype=torch.bfloat16, seed=1)
        for row in phase_video_sharded(vd, dev, smi):
            emit(row)
            ok &= row["ok"]
        from spider_tpu_torch.common import dist

        dist.destroy()
        emit(dict(phase="total", seconds=time.perf_counter() - started))
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a video_sharded row failed (see the JSON lines above)",
                  file=sys.stderr)
        return 0 if ok else 1

    if parallel_only:
        for row in phase_parallel(dev, smi)[0]:
            emit(row)
            ok &= row["ok"]
        emit(dict(phase="total", seconds=time.perf_counter() - started))
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a parallel row failed (see the JSON lines above)",
                  file=sys.stderr)
        return 0 if ok else 1

    if family_only:
        model, tokenizer = factory.from_pretrained("llama", device=dev, seed=0)
        for row in family_phases(model, tokenizer, dev, smi):
            emit(row)
            ok &= row["ok"]
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a family row failed (see the JSON lines above)", file=sys.stderr)
        return 0 if ok else 1

    spider_free_T = spider_free_prompt_len(TinyTokenizer())

    # ---- kernel vs plain (these launches are not the main path's)
    rows = (phase_kernel_flash(dev, spider_free_T) + phase_kernel_flash_bwd(dev)
            + phase_kernel_tattn(dev) + phase_kernel_paged(dev) + phase_kernel_int4(dev)
            + phase_kernel_group_norm(dev))
    for row in rows:
        emit(dict(phase="kernel", nvidia_smi=smi, **row))
        ok &= row["ok"]
    for check in ([phase_floors(rows, spider_free_T), phase_int4_crossover(dev),
                   phase_wrapper_us(dev), phase_tattn_grad(dev)] + phase_unet_routing(dev)
                  + phase_story_bank_routing(dev)):
        emit(dict(nvidia_smi=smi, **check))
        ok &= check["ok"]
    if kernels_only:
        print(smi, flush=True)
        if not ok:
            print("chip_smoke: a kernel row failed (see the JSON lines above)", file=sys.stderr)
        return 0 if ok else 1

    model, tokenizer = factory.from_pretrained("llama", device=dev, seed=0)
    assert spider_free_prompt_len(tokenizer) == spider_free_T

    model4, _ = factory.from_pretrained("llama", device=dev, seed=0, quantization="int4")
    for check in (phase_paged_check(model, dev), phase_int4_check(model4, dev)):
        emit(check)
        ok &= check["ok"]

    sd = factory.from_pretrained("sd15", device=dev, dtype=torch.bfloat16, seed=0)
    check = phase_unet_check(sd, dev)
    emit(check)
    ok &= check["ok"]
    vd = factory.from_pretrained("zeroscope", device=dev, dtype=torch.bfloat16, seed=1)
    for check in (phase_unet3d_check(vd, dev), phase_video_profile(vd, dev)):
        emit(check)
        ok &= check["ok"]
    ad = factory.from_pretrained("audioldm", device=dev, dtype=torch.bfloat16, seed=2)
    assert tuple(ad.latent_shape(1, AUDIO_SECONDS)[1:3]) == AUDIO_LATENT_HW

    # ---- the main paths: chat, text+image requests, any-to-many requests,
    # continuous-batching serving, then training; each phase zeroes the
    # counts before it runs and reads them after.
    main_launches = dict.fromkeys(KERNELS, 0)
    phases = [phase_chat(model, tokenizer, spider_free_T)]
    phases += phase_request(model, tokenizer, sd)
    phases += phase_any_to_many(model, tokenizer, sd, ad, vd)
    phases += phase_http(model, tokenizer, sd, ad, vd)
    phases += [phase_orchestrator(sd, ad, vd, dev)]
    phases += phase_serving(model, model4, tokenizer)
    for row in phases:
        emit(row)
        ok &= row["ok"]
        for name in KERNELS:
            main_launches[name] += row["launches"][name]
    # speculation, streaming and the wave batcher on the 8B chat model, then
    # Qwen2-7B, Llama-2-7B and the MoE Llama, each freeing its models
    for row in family_phases(model, tokenizer, dev, smi):
        emit(row)
        ok &= row["ok"]
        _add_launches(main_launches, row["launches"])
    # the SDXL story path: story_check (no main-path launches), then the
    # story, the story through SpiderFree and HTTP, and PhotoMaker
    for row in phase_story(model, tokenizer, dev, smi):
        emit(row)
        ok &= row["ok"]
        if "launches" in row:
            _add_launches(main_launches, row["launches"])
    torch.cuda.empty_cache()
    # BOX and MASK: Grounding DINO and SAM ViT-H through the decoder twin
    for row in phase_grounding(dev, smi):
        emit(row)
        ok &= row["ok"]
        if "launches" in row:
            _add_launches(main_launches, row["launches"])
    torch.cuda.empty_cache()
    # Qwen2.5-Omni: text and speech out of one request (omni, omni_check,
    # omni_profile), its models freed after
    for row in phase_omni(dev, smi):
        emit(row)
        ok &= row["ok"]
        if "launches" in row:
            _add_launches(main_launches, row["launches"])
    torch.cuda.empty_cache()

    # The trainer needs the card's memory: the two chat models go first.
    del model, model4
    torch.cuda.empty_cache()
    train_rows, train_launches, handoff = phase_train(sd, ad, vd, dev, smi)
    for row in train_rows:
        emit(row)
        ok &= row["ok"]
    _add_launches(main_launches, train_launches)
    del train_rows

    # Serve what was trained: SpiderInference restores the checkpoint the
    # train phase wrote, then Spider.generate and the decoders.
    try:
        gen_rows, gen_launches = phase_spider_generate(handoff, sd, ad, vd, dev, smi)
    finally:
        shutil.rmtree(handoff["out_dir"], ignore_errors=True)
    for row in gen_rows:
        emit(row)
        ok &= row["ok"]
    _add_launches(main_launches, gen_launches)

    # The production recipe, train_configs/spider_train.py, at full width on
    # real-format data: a step from each of its 21 builders and a short epoch
    data_rows, data_launches = phase_train_data(sd, ad, vd, dev, smi)
    for row in data_rows:
        emit(row)
        ok &= row["ok"]
    _add_launches(main_launches, data_launches)
    del data_rows

    # The sharded video denoise and decode over the NCCL world of one (the
    # process group it starts stays up for the parallel phase)
    for row in phase_video_sharded(vd, dev, smi):
        emit(row)
        ok &= row["ok"]
        if "launches" in row:
            _add_launches(main_launches, row["launches"])

    # The training side of the multi-card code on this one card: the NCCL
    # world of one, the ring at 8B width, the sharded runner against the
    # unwrapped one; then the checkpoint slice: real layouts written at full
    # size and loaded; the card's memory goes to the 8B checkpoint and the
    # Spider built on it.
    del sd, ad, vd
    torch.cuda.empty_cache()
    par_rows, par_launches = phase_parallel(dev, smi)
    for row in par_rows:
        emit(row)
        ok &= row["ok"]
    _add_launches(main_launches, par_launches)
    ckpt_ok, ckpt_launches = phase_checkpoint(dev, smi)
    ok &= ckpt_ok
    for name in KERNELS:
        main_launches[name] += ckpt_launches[name]
    ok &= all(n > 0 for n in main_launches.values())

    # One row per kernel at a shape its main path gives it (name of the row
    # in the `kernel` lines above).
    summary = [
        ("flash_fwd", "unet_self_T4096_D40", "flash_fwd", "attention.py:67"),
        ("flash_bwd_dq", f"train_B{TRAIN_LM_SHAPE[0]}_T{TRAIN_LM_SHAPE[1]}", "flash_bwd",
         "attention.py:263"),
        ("flash_bwd_dkv", f"train_B{TRAIN_LM_SHAPE[0]}_T{TRAIN_LM_SHAPE[1]}", "flash_bwd",
         "attention.py:299"),
        ("tattn_fwd", "zeroscope_L0_D40", "tattn_fwd", "temporal_attention.py:45"),
        ("paged_decode", "serving_B16_MP4", "paged_decode", "paged_attention.py:31"),
        ("int4_matmul", "gate_up_M16", "int4_matmul", "quant.py:65"),
        # port-only: the JAX package leaves GroupNorm to XLA
        ("group_norm", "zeroscope_video_L0", "group_norm", None)]
    kernels = []
    for kernel, shape_row, source, replaces in summary:
        mine = [r for r in rows if r["kernel"] == kernel]
        row = next(r for r in mine if r["name"] == shape_row)
        entry = dict(
            name=kernel, route="cuda", source=f"spider_tpu_torch/csrc/{source}.cu",
            replaces=replaces and f"spider_tpu/ops/{replaces}", launches=main_launches[kernel],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=shape_row, device_ms=row.get("device_ms"))
        if "previous_ms" in row:   # which of the source's kernels, and the first one's time
            entry.update(kernel_route=row["route"], previous_ms=row["previous_ms"],
                         previous_device_ms=row["previous_device_ms"],
                         max_abs_err=max(max(r["max_abs_err"], r["max_abs_err_previous"])
                                         for r in mine))
        kernels.append(entry)
    emit(dict(phase="total", seconds=time.perf_counter() - started))
    emit({"kernels": kernels})
    print(smi, flush=True)
    if not ok:
        print("chip_smoke: a phase failed (see the JSON lines above)", file=sys.stderr)
        return 1
    # The run uses one device, cuda:0, whatever else the machine shows.
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
