"""Cells whose requests are ``<IMAGESTORY>`` answers through
``SpiderDecoderInfer``: Spider's story decoder, SDXL with StoryDiffusion's
consistent self-attention (``models/pipelines/sdxl_story.py``).

Set-up builds ``factory.from_pretrained(config["pipeline"])`` in the
configuration's dtype, fills its four modules' weights from the seed
(``weights.fill``) and makes the controller as SpiderFree does:
``SpiderDecoderInfer`` with, as its ``story_fn``, the ``functools.partial``
of ``story_generation`` at the workload's point. The window is the closed
loop of ``spider_decoder.run_window``, one client: each request is one
tagged answer holding one IMAGESTORY span whose general prompt and
``frames`` scenes are drawn from the caption pool and whose style from
``tags.STYLE_NAMES`` by (seed, request); the story's own seed, which gives
its noise and its bank indices, is drawn from (seed, request) too.

Every request records, through thin proxies of the pipeline's prompt
encoding, UNet and scheduler, what the check compares: the prompts the
pipeline encoded, its conditioning and pooled vector as the UNet got them,
its initial latents, the latents before and after two of its steps drawn
from the seed with the noise prediction there, its final latents and its
frames; and, through forward hooks at the first of those steps, the input
and output of the first consistent self-attention of each up level. With
``trace`` it times on the host what ``spider_decoder`` times (the request,
the story call as its decoder span, the denoise loop and the decode), and
records the program's spans and the profiled slice as there.

The check (``CHECK_NAMES``; each number the largest over the sample):
  noise_max_abs  the initial latents over the reference's initial sigma
                 against the same unit draw from the story's seed;
  text_rel_l2    the conditioning [uncond; cond] against both reference
                 encoders' penultimate states on the same prompts;
  pooled_rel_l2  the pooled vector [uncond; cond] against the second
                 encoder's projected EOS state;
  unet_rel_l2    the CFG noise prediction at step k against the reference
                 UNet's at the program's latents, conditioning and pooled
                 vector, the reference's own time ids and bank indices;
  bank_rel_l2    each hooked consistent self-attention's output against the
                 reference's at the program's input of it, with the
                 reference's own bank indices (random N(0, 0.02) weights
                 spread attention nearly evenly over the keys, so the bank
                 moves a whole UNet call's output less than its bf16 error
                 does, and only this number sees it at the cell's size);
  euler_rel      the latents after step k against the reference's guidance
                 and Euler step from the program's latents and noise
                 prediction, over the size of that step;
  vae_rel_l2     the frames against the reference's decode of the final
                 latents, over the frames' spread about their mean.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import profiling, traffic, weights
from benchmark.check import rel_l2, spread_rel
from benchmark.flops import _count
from benchmark.loops import spider_decoder as D
from benchmark.reference import build, sdxl
from benchmark.reference.layers import set_fp8
from spider_tpu_torch.common import profiler

CHECK_NAMES = ("noise_max_abs", "text_rel_l2", "pooled_rel_l2", "unet_rel_l2", "bank_rel_l2",
               "euler_rel", "vae_rel_l2")
MODULES = ("text_encoder", "text_encoder_2", "unet", "vae")
CFG_GROUPS = 2               # batched CFG: the uncond and the cond rows, a bank each

run_window, warm_up, check_sample = D.run_window, D.warm_up, D.check_sample


def build_pipeline(config: dict, device):
    from spider_tpu_torch.models.factory import from_pretrained

    return from_pretrained(config["pipeline"], device=device,
                           dtype=getattr(torch, config["dtype"]))


def latent_hw(config: dict, point: dict):
    factor = 2 ** (len(config["vae_as_run"]["block_out_channels"]) - 1)
    return point["height"] // factor, point["width"] // factor


def bank_indices(config: dict, point: dict, seed: int) -> Dict[str, np.ndarray]:
    """{up block path: sorted indices} of each consistent up block's bank:
    int(id_length x tokens x sa_ratio) distinct tokens (at least one) of a
    group's first id_length rows at the block's level, drawn block by block,
    up level by up level, from ``np.random.default_rng(seed)``."""
    cfg, (h, w) = config["unet_as_run"], latent_hw(config, point)
    rng = np.random.default_rng(seed)
    n, out = len(cfg["block_out_channels"]), {}
    for i in range(n):
        level = n - 1 - i
        if not (cfg["cross_attn_blocks"][level] and cfg["transformer_layers_per_block"][level]):
            continue
        total = point["id_length"] * (h // 2 ** level) * (w // 2 ** level)
        for j in range(cfg["layers_per_block"] + 1):
            idx = rng.choice(total, size=max(1, int(total * point["sa_ratio"])), replace=False)
            out[f"up_{i}_attn_{j}"] = np.sort(idx).astype(np.int64)
    return out


def answer(workload: dict, pool: List[str], seed: int, index: int):
    """(the tagged answer of request `index`, (general prompt, scenes,
    style)) in the grammar of Spider's system prompt."""
    from spider_tpu_torch.models.tags import STYLE_NAMES

    rng = np.random.default_rng(weights.derive_seed(seed, index, 3))
    picks = rng.choice(len(pool), 1 + workload["point"]["frames"], replace=False)
    general, scenes = pool[picks[0]], [pool[i] for i in picks[1:]]
    style = STYLE_NAMES[int(rng.integers(len(STYLE_NAMES)))]
    span = (f"<IMAGESTORY><GENERALPROMPT>'{general}'</GENERALPROMPT>, <PROMPTARRAY>{scenes!r}"
            f"</PROMPTARRAY>, <STYLENAME>'{style}'</STYLENAME></IMAGESTORY>")
    return workload["answer_template"].format(span=span), (general, scenes, style)


def bank_paths(config: dict, point: dict) -> List[str]:
    """The first consistent transformer of each up level, whose first
    block's self-attention the check compares."""
    return [path for path in bank_indices(config, point, 0) if path.endswith("_attn_0")]


def attn1(unet, path: str):
    """The self-attention of the first transformer block of `path`."""
    return unet.get_submodule(f"{path}.block_0.attn1")


class Recorder:
    """Proxies of the pipeline's ``encode_prompt``, UNet and scheduler, and
    forward hooks on the self-attentions of `hooked` up blocks, that keep
    device copies of what the check compares, for the request ``begin``
    names."""

    def __init__(self, pipe, steps: int, hooked=()):
        self.steps = steps
        self.records: Dict[int, dict] = {}
        self.cur: Optional[dict] = None
        self.unet_calls = self.steps_taken = 0
        unet, sched, encode, rec = pipe.unet, pipe.scheduler, pipe.encode_prompt, self

        class UNetProxy:
            def __getattr__(self, name):
                return getattr(unet, name)

            def __call__(self, x, t, context, added_cond=None, **kw):
                out = unet(x, t, context, added_cond=added_cond, **kw)
                rec._unet(context, added_cond, out)
                return out

        class SchedulerProxy:
            def __getattr__(self, name):
                return getattr(sched, name)

            def step(self, eps, sigma, sigma_next, sample):
                out = sched.step(eps, sigma, sigma_next, sample)
                rec._step(sample, out)
                return out

        def encode_prompt(prompts):
            if rec.cur is not None:
                rec.cur["prompts"].append(list(prompts))
            return encode(prompts)

        for path in hooked:
            attn1(unet, path).register_forward_hook(functools.partial(self._attn, path),
                                                    with_kwargs=True)
        pipe.unet, pipe.scheduler, pipe.encode_prompt = UNetProxy(), SchedulerProxy(), encode_prompt

    def begin(self, index: int, seed: int, sample_steps) -> None:
        self.cur = dict(seed=seed, steps=sorted(sample_steps), prompts=[], latents={}, eps={},
                        attn={})
        self.records[index] = self.cur
        self.unet_calls = self.steps_taken = 0

    def _unet(self, context, added_cond, out):
        cur, c = self.cur, self.unet_calls
        self.unet_calls += 1
        if cur is None:
            return
        if c == 0:
            cur["context"] = context.detach().clone()
            cur["text_embeds"] = added_cond["text_embeds"].detach().clone()
        if c in cur["steps"]:
            cur["eps"][c] = out.detach().clone()

    def _attn(self, path, module, args, kwargs, out):
        cur = self.cur
        if cur is not None and self.unet_calls == cur["steps"][0]:
            cur["attn"][path] = (args[0].detach().clone(), out.detach().clone())

    def _step(self, sample, out):
        cur, c = self.cur, self.steps_taken
        self.steps_taken += 1
        if cur is None:
            return
        if c == 0 or c in cur["steps"]:
            cur["latents"][c] = sample.detach().clone()
        if c in cur["steps"] or c == self.steps - 1:
            cur["latents"][c + 1] = out.detach().clone()


class Cell:
    """One story cell's pipeline, controller and recordings on `device`."""

    def __init__(self, workload: dict, config: dict, seed: int, device,
                 build: Callable = build_pipeline, trace: bool = False):
        from spider_tpu_torch.common.config import Config
        from spider_tpu_torch.models import spider_decoder  # noqa: F401 (registers the model)
        from spider_tpu_torch.models.pipelines.sdxl_story import story_generation
        from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer

        self.workload, self.config, self.seed = workload, config, seed
        self.device = torch.device(device)
        self.trace = trace
        self.program_spans: Dict[int, object] = {}
        self.point = p = workload["point"]
        self.pool = traffic.captions(workload)
        self.pipe = build(config, self.device)
        self.modules = {name: getattr(self.pipe, name) for name in MODULES}
        self.specs = weights.module_specs(self.modules)
        self.reseed(seed)
        self.recorder = Recorder(self.pipe, p["num_inference_steps"], bank_paths(config, p))
        self.spans = D.Spans(self.device)
        if trace:
            D.trace_pipeline(self.pipe, self.spans)
        story = functools.partial(story_generation, self.pipe, id_length=p["id_length"],
                                  sa_ratio=p["sa_ratio"],
                                  num_inference_steps=p["num_inference_steps"],
                                  height=p["height"], width=p["width"])
        self.request = None

        def story_fn(**kw):
            story_seed = weights.derive_seed(self.seed, self.request)
            rng = np.random.default_rng(weights.derive_seed(self.seed, self.request, 1))
            steps = rng.choice(p["num_inference_steps"], workload["check"]["steps_per_request"],
                               replace=False)
            self.recorder.begin(self.request, story_seed, [int(s) for s in steps])
            t0 = time.perf_counter()
            out = story(seed=story_seed, **kw)
            self.spans.add("decoder", t0, time.perf_counter())
            return out

        self.infer = SpiderDecoderInfer(Config.fromdict(dict(model=dict(type="spider_decoder"))),
                                        decoders={}, story_fn=story_fn)

    def reseed(self, seed: int) -> None:
        """Weights, traffic and generators from `seed`; recordings dropped."""
        self.seed = seed
        weights.load_into(self.modules, weights.fill(self.specs, seed, self.device,
                                                     getattr(torch, self.config["dtype"])))
        if hasattr(self, "recorder"):
            self.recorder.records.clear()

    def serve(self, index: int) -> dict:
        """Request `index`: its answer through ``SpiderDecoderInfer``; -> its
        predictions."""
        text, _ = answer(self.workload, self.pool, self.seed, index)
        self.request = self.spans.index = index
        t0 = time.perf_counter()
        try:
            _, preds, _ = self.infer({"llm_text_all": [text]})
        finally:
            t1 = time.perf_counter()
            if self.trace:
                self.program_spans[index] = profiling.compact(profiler.drain())
        self.spans.add("request", t0, t1)
        self.recorder.cur = None
        stories = preds["IMAGESTORY"]
        if len(stories) != 1:
            raise RuntimeError(f"request {index}: {len(stories)} stories rendered, not 1")
        self.recorder.records[index]["output"] = np.stack(stories[0])
        return preds

    def free_program(self) -> None:
        """Drop the program's modules (the recorder's proxies and hooks hold
        them too) and the device memory they held."""
        self.pipe = self.infer = self.modules = self.recorder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def records_of(cell: Cell, indices: List[int]) -> List[dict]:
    return [cell.recorder.records[i] for i in indices]


def reference_values(cell: Cell) -> Dict[str, torch.Tensor]:
    """The run's weights, drawn again from the seed over the program's names
    and shapes."""
    return weights.fill(cell.specs, cell.seed, cell.device, getattr(torch, cell.config["dtype"]))


class Reference:
    """The configuration's reference models in fp32 on `device`, with the
    run's weights, and the operations the check needs."""

    def __init__(self, config: dict, workload: dict, values: Dict[str, torch.Tensor], device):
        self.config, self.point, self.device = config, workload["point"], device
        self.modules = sdxl.models(config, device)
        self.text, self.text_2, self.unet, self.vae = self.modules
        self.load(values)
        self.steps = self.point["num_inference_steps"]
        self.sigmas, self.timesteps = sdxl.euler_schedule(config["scheduler"], self.steps)
        self.init_sigma = sdxl.init_noise_sigma(self.sigmas)

    def load(self, values: Dict[str, torch.Tensor]) -> None:
        for module, prefix in zip(self.modules, MODULES):
            build.load(module, prefix, values)

    def fp8(self, on: bool) -> None:
        for m in self.modules:
            set_fp8(m, on)

    @torch.no_grad()
    def encode(self, prompts: List[str]):
        """(conditioning [N, 77, 2048], pooled [N, 1280]) of `prompts`."""
        ids = [torch.tensor([sdxl.token_ids(p, cfg["max_position_embeddings"],
                                            cfg["eos_token_id"]) for p in prompts],
                            device=self.device)
               for cfg in (self.config["text_encoder_as_run"],
                           self.config["text_encoder_2_as_run"])]
        h1, _ = self.text(ids[0])
        h2, pooled = self.text_2(ids[1])
        return torch.cat([h1, h2], dim=-1), pooled

    def noise(self, seed: int, shape) -> torch.Tensor:
        """The unit draw of the story's seed on the reference's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=self.device)

    def story(self, seed: int) -> Dict[str, dict]:
        idx = {path: torch.from_numpy(v).to(self.device)
               for path, v in bank_indices(self.config, self.point, seed).items()}
        return sdxl.story_of(idx, self.point["id_length"], CFG_GROUPS)

    @torch.no_grad()
    def eps(self, latents, k: int, context, text_embeds, story) -> torch.Tensor:
        """The CFG pair's noise prediction [2B, h, w, 4] at step k from the
        latents before it."""
        x = sdxl.scale_input(latents.to(self.device, torch.float32), self.sigmas[k])
        x = torch.cat([x, x])
        n = x.shape[0]
        h, w = self.point["height"], self.point["width"]
        time_ids = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32,
                                device=self.device).repeat(n, 1)
        t = torch.full((n,), self.timesteps[k], device=self.device)
        return self.unet(x, t, context.to(self.device, torch.float32),
                         text_embeds.to(self.device, torch.float32), time_ids, story)

    @torch.no_grad()
    def bank_attention(self, path: str, h, story) -> torch.Tensor:
        """The consistent self-attention of `path`'s first block at its
        input h [B, T, C]."""
        return sdxl.consistent_attention(attn1(self.unet, path), h.to(self.device, torch.float32),
                                         story[path])

    def step(self, latents, eps, k: int) -> torch.Tensor:
        eu, ec = eps.to(self.device).float().chunk(2)
        return sdxl.guided_euler_step(latents.to(self.device), eu, ec,
                                      self.point["guidance_scale"], self.sigmas[k],
                                      self.sigmas[k + 1])

    @torch.no_grad()
    def decode(self, final: torch.Tensor, block: int = 1) -> torch.Tensor:
        """The frames [B, H, W, 3] in [0, 1] of these final latents, on the
        host, decoded `block` at a time."""
        flat = final.to(self.device, torch.float32)
        return torch.cat([(self.vae(flat[i:i + block]) / 2 + 0.5).clamp(0.0, 1.0).cpu()
                          for i in range(0, flat.shape[0], block)])


def reference_for(cell: Cell) -> Reference:
    """The reference on the cell's device with the run's weights."""
    return Reference(cell.config, cell.workload, reference_values(cell), cell.device)


def program_numbers(ref: Reference, records: List[dict]) -> Dict[str, float]:
    """The six numbers, each the largest over the recorded requests."""
    worst = dict.fromkeys(CHECK_NAMES, 0.0)

    def keep(name, value):
        worst[name] = max(worst[name], value)

    dev = ref.device
    for rec in records:
        lat = {k: v.to(dev) for k, v in rec["latents"].items()}
        keep("noise_max_abs", float((lat[0] / ref.init_sigma
                                     - ref.noise(rec["seed"], lat[0].shape)).abs().max()))
        cond, uncond = rec["prompts"]
        ctx, pooled = ref.encode(uncond + cond)
        keep("text_rel_l2", rel_l2(rec["context"].to(dev), ctx))
        keep("pooled_rel_l2", rel_l2(rec["text_embeds"].to(dev), pooled))
        story = ref.story(rec["seed"])
        for k in rec["steps"]:
            eps = rec["eps"][k].to(dev)
            keep("unet_rel_l2", rel_l2(eps, ref.eps(lat[k], k, rec["context"],
                                                    rec["text_embeds"], story)))
            keep("euler_rel", rel_l2(lat[k + 1] - lat[k], ref.step(lat[k], eps, k) - lat[k]))
        for path, (h, out) in rec["attn"].items():
            keep("bank_rel_l2", rel_l2(out.to(dev), ref.bank_attention(path, h, story)))
        want = ref.decode(lat[ref.steps])
        got = torch.as_tensor(np.asarray(rec["output"], dtype=np.float32)).reshape(want.shape)
        keep("vae_rel_l2", spread_rel(got, want))
    return worst


def control_numbers(ref: Reference, records: List[dict]) -> Dict[str, float]:
    """The numbers of the reference computed in fp8 put in the program's
    place at the program's recorded inputs: its conditioning and pooled
    vector, its noise prediction at each sampled step, its hooked consistent
    self-attentions, its decode of the final latents."""
    worst = dict(text_rel_l2=0.0, pooled_rel_l2=0.0, unet_rel_l2=0.0, bank_rel_l2=0.0,
                 vae_rel_l2=0.0)

    def parts(rec, story):
        cond, uncond = rec["prompts"]
        ctx, pooled = ref.encode(uncond + cond)
        eps = [ref.eps(rec["latents"][k], k, rec["context"], rec["text_embeds"], story)
               for k in rec["steps"]]
        bank = [ref.bank_attention(path, h, story) for path, (h, _) in rec["attn"].items()]
        return dict(text_rel_l2=[ctx], pooled_rel_l2=[pooled], unet_rel_l2=eps,
                    bank_rel_l2=bank, vae_rel_l2=[ref.decode(rec["latents"][ref.steps])])

    for rec in records:
        story = ref.story(rec["seed"])
        want = parts(rec, story)
        ref.fp8(True)
        try:
            got = parts(rec, story)
        finally:
            ref.fp8(False)
        for name in worst:
            diff = spread_rel if name == "vae_rel_l2" else rel_l2
            worst[name] = max([worst[name]] + [diff(g, w) for g, w in zip(got[name], want[name])])
    return worst


def request_flops(config: dict, point: dict) -> dict:
    """{part: operations} of one story at the operating point, from the
    reference models on the meta device (matrix products, convolutions and
    attention, 2 operations a multiply-add): both text encoders on the
    ``frames`` prompts and as many negative prompts, ``steps`` CFG calls of
    the UNet at batch 2 x frames with the bank where ``id_length`` > 0, the
    VAE decode of every frame; "total" sums them."""
    dev = torch.device("meta")
    text, text_2, unet, vae = sdxl.models(config, dev)
    B, n = 2 * point["frames"], config["text_encoder_as_run"]["max_position_embeddings"]
    h, w = latent_hw(config, point)
    story = None
    if point["id_length"] > 0:
        idx = {path: torch.zeros(len(v), dtype=torch.long, device=dev)
               for path, v in bank_indices(config, point, 0).items()}
        story = sdxl.story_of(idx, point["id_length"], CFG_GROUPS)
    z = lambda *shape: torch.zeros(shape, device=dev)
    ids = torch.zeros((B, n), dtype=torch.long, device=dev)
    with torch.no_grad():
        text_f = _count(lambda: text(ids)) + _count(lambda: text_2(ids))
        unet_f = _count(lambda: unet(z(B, h, w, 4), z(B), z(B, n, unet.cfg["cross_attention_dim"]),
                                     z(B, config["text_encoder_2_as_run"]["projection_dim"]),
                                     z(B, 6), story))
        vae_f = _count(lambda: vae(z(point["frames"], h, w, 4)))
    parts = dict(text_encoder=text_f, unet=point["num_inference_steps"] * unet_f,
                 vae_decode=vae_f, unet_call=unet_f)
    parts["total"] = parts["text_encoder"] + parts["unet"] + parts["vae_decode"]
    return parts
