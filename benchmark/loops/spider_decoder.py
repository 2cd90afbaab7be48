"""Cells whose requests are tagged answers through ``SpiderDecoder.generate``.

Set-up builds the cell's one pipeline with ``factory.from_pretrained``, fills
its weights from the seed (``weights.fill``), makes the decoder callable with
``spider_decoder_infer.build_default_decoders(tiny=False)`` (the only
pipeline it is handed is this one) and a ``SpiderDecoder`` holding that one
modality, and runs one request at the cell's shapes. The window is a closed
loop with one client: each request is one tagged answer, its spans rendered
one after another, each span with a generator of its own drawn from (seed,
request, span). Requests are issued until the window's seconds have passed;
the one in flight then finishes and counts.

Every request records, through thin proxies of the pipeline's UNet and VAE,
what the check compares: its conditioning, its initial latents, the latents
and noise prediction at two of its steps drawn from the seed, and its final
latents, each a device copy (a few kernels a request).

With ``trace`` the spans of each request are timed on the host (the request,
each decoder call, its denoise loop, which then ends in a synchronise, and
its decode, which ends in the copy to the host); the warm-up and the window
run under the program's ``profiler.recording()``, and the program's spans and
launch records are drained after each request into the window's
``program_spans`` (``profiling.compact``); and the request in flight at the
window's end runs under ``torch.profiler`` (``profiling.Slice``). Without
``trace`` nothing records.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Callable, Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from benchmark import check, flops, profiling, traffic, weights
from spider_tpu_torch.common import profiler

# The configuration's models for the count and the comparison: the SD-style
# UNet, its text encoder and VAE.
request_flops = flops.request_flops
program_numbers = check.program_numbers
CHECK_NAMES = check.NAMES


def build_pipeline(config: dict, device):
    from spider_tpu_torch.models.factory import from_pretrained

    return from_pretrained(config["pipeline"], device=device,
                           dtype=getattr(torch, config["dtype"]))


def pipeline_modules(pipe) -> Dict[str, torch.nn.Module]:
    return {"text_encoder": pipe.text_encoder, "unet": pipe.unet, "vae": pipe.vae}


def program_decoder(pipe, kind: str, modality: str, device, dtype) -> Callable:
    """The callable ``build_default_decoders(tiny=False)`` makes for
    `modality`, around `pipe`; no other pipeline is built."""
    from spider_tpu_torch import spider_decoder_infer
    from spider_tpu_torch.models import factory

    def only_this(k, path=None, **kw):
        if k == kind:
            return pipe
        return None

    with mock.patch.object(factory, "from_pretrained", only_this):
        decoders = spider_decoder_infer.build_default_decoders(
            tiny=False, with_grounding=False, device=device, dtype=dtype)
    return decoders[modality]


class Recorder:
    """Proxies of the pipeline's UNet and VAE that keep device copies of what
    the check compares, for the request ``begin`` names."""

    def __init__(self, pipe, steps: int):
        self.steps = steps
        self.records: Dict[int, dict] = {}
        self.cur: Optional[dict] = None
        self.call = 0
        unet, vae, rec = pipe.unet, pipe.vae, self

        class UNetProxy:
            def __getattr__(self, name):
                return getattr(unet, name)

            def __call__(self, lat_in, t, context, *a, **kw):
                out = unet(lat_in, t, context, *a, **kw)
                rec._unet(lat_in, context, out)
                return out

        class VAEProxy:
            def __getattr__(self, name):
                return getattr(vae, name)

            def decode(self, z):
                rec._final(z)
                return vae.decode(z)

        pipe.unet, pipe.vae = UNetProxy(), VAEProxy()

    def begin(self, index: int, caption: str, generator_seed: int, sample_steps) -> None:
        self.cur = dict(caption=caption, generator_seed=generator_seed,
                        steps=sorted(sample_steps), latents={}, eps={})
        self.records.setdefault(index, dict(spans=[]))["spans"].append(self.cur)
        self.call = 0

    def _unet(self, lat_in, context, out):
        cur, c = self.cur, self.call
        self.call += 1
        if cur is None:
            return
        half = lat_in.shape[0] // 2
        if c == 0:
            cur["context"] = context.detach().clone()
        if c == 0 or c in cur["steps"] or c - 1 in cur["steps"]:
            cur["latents"][c] = lat_in[:half].detach().clone()
        if c in cur["steps"]:
            cur["eps"][c] = out.detach().clone()

    def _final(self, z):
        cur = self.cur
        if cur is not None:
            cur["latents"][self.steps] = z.detach().clone().reshape(cur["latents"][0].shape)


class Spans:
    """Host-clock spans of the traced run, by request."""

    def __init__(self, device):
        self.device = device
        self.by_request: Dict[int, dict] = {}
        self.index = None

    def add(self, kind: str, start: float, end: float) -> None:
        if self.index is not None:
            self.by_request.setdefault(self.index, {}).setdefault(kind, []).append((start, end))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def trace_pipeline(pipe, spans: Spans) -> None:
    """Time the pipeline's denoise loop (ending it in a synchronise) and its
    decode on the host."""
    make_run, decode = pipe._denoise_fn, pipe._decode_latents

    def denoise_fn(*a, **kw):
        run = make_run(*a, **kw)

        def timed(*ra, **rkw):
            t0 = time.perf_counter()
            out = run(*ra, **rkw)
            spans.sync()
            spans.add("denoise", t0, time.perf_counter())
            return out

        return timed

    def timed_decode(latents):
        t0 = time.perf_counter()
        out = decode(latents)
        spans.add("vae_decode", t0, time.perf_counter())
        return out

    pipe._denoise_fn, pipe._decode_latents = denoise_fn, timed_decode


class Cell:
    """One cell's pipeline, controller and recordings on `device`."""

    def __init__(self, workload: dict, config: dict, seed: int, device,
                 build: Callable = build_pipeline, call_kwargs: Optional[dict] = None,
                 trace: bool = False):
        from spider_tpu_torch.models.spider_decoder import SpiderDecoder

        self.workload, self.config, self.seed = workload, config, seed
        self.device = torch.device(device)
        self.trace = trace
        self.program_spans: Dict[int, object] = {}
        self.point = workload["point"]
        self.modality = workload["modality"]
        self.pool = traffic.captions(workload)
        dtype = getattr(torch, config["dtype"])
        self.pipe = build(config, self.device)
        self.modules = pipeline_modules(self.pipe)
        self.specs = weights.module_specs(self.modules)
        self.reseed(seed)
        self.recorder = Recorder(self.pipe, self.point["num_inference_steps"])
        self.spans = Spans(self.device)
        if trace:
            trace_pipeline(self.pipe, self.spans)
        fn = program_decoder(self.pipe, config["pipeline"], self.modality, self.device, dtype)
        extra = dict(call_kwargs or {})
        self.request = None

        def decoder(prompts, **kw):
            caption = prompts[0]
            span = len(self.recorder.records.get(self.request, {}).get("spans", []))
            gen_seed = weights.derive_seed(self.seed, self.request, span)
            rng = np.random.default_rng(weights.derive_seed(self.seed, self.request, span, 1))
            steps = rng.choice(self.point["num_inference_steps"],
                               workload["check"]["steps_per_request"], replace=False)
            self.recorder.begin(self.request, caption, gen_seed, [int(s) for s in steps])
            gen = torch.Generator(device=self.device).manual_seed(gen_seed)
            t0 = time.perf_counter()
            out = fn(prompts, **{**kw, "generator": gen, **extra})
            self.spans.add("decoder", t0, time.perf_counter())
            return out

        self.controller = SpiderDecoder(decoders={self.modality: decoder})

    def reseed(self, seed: int) -> None:
        """Weights, traffic and generators from `seed`; recordings dropped."""
        self.seed = seed
        weights.load_into(self.modules, weights.fill(self.specs, seed, self.device,
                                                     getattr(torch, self.config["dtype"])))
        if hasattr(self, "recorder"):
            self.recorder.records.clear()

    def serve(self, index: int) -> dict:
        """Request `index`: its answer through ``SpiderDecoder.generate``;
        -> its predictions."""
        from spider_tpu_torch.models.spider_decoder import (empty_predictions,
                                                            empty_predictions_text)

        text, _ = traffic.answer(self.workload, self.pool, self.seed, index)
        self.request = self.spans.index = index
        preds, preds_text = empty_predictions(), empty_predictions_text()
        t0 = time.perf_counter()
        try:
            self.controller.generate({"llm_text_all": [text]}, [], preds, preds_text)
        finally:
            t1 = time.perf_counter()
            if self.trace:
                self.program_spans[index] = profiling.compact(profiler.drain())
        self.spans.add("request", t0, t1)
        self.recorder.cur = None
        outs = preds[self.modality]
        for span, out in zip(self.recorder.records[index]["spans"], outs):
            span["output"] = out
        return preds

    def free_program(self) -> None:
        """Drop the program's modules and the device memory they held."""
        self.pipe = self.controller = self.modules = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def recording(cell: Cell):
    """The program's ``profiler.recording()`` where the cell is traced, else
    nothing."""
    return profiler.recording() if cell.trace else contextlib.nullcontext()


def run_window(cell: Cell, seconds: float) -> dict:
    """The closed loop. -> latencies, completions and, traced, the spans,
    the program's recordings and the profiled slice."""
    with recording(cell):
        return _window(cell, seconds)


def _window(cell: Cell, seconds: float) -> dict:
    trace = cell.trace
    lat: List[float] = []
    starts: List[float] = []
    failed: List[int] = []
    profiled = None
    prof_slice = None
    estimate = None
    t0 = time.perf_counter()
    index = 0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        profile_this = (trace and profiled is None and estimate is not None
                        and now - t0 + estimate >= seconds)
        with contextlib.ExitStack() as stack:
            if profile_this:
                prof_slice = stack.enter_context(profiling.Slice(cell.device))
                profiled = index
            s = time.perf_counter()
            try:
                cell.serve(index)
            except Exception as e:   # a failed request counts against the run
                failed.append(index)
                print(f"request {index} failed: {type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
            e_ = time.perf_counter()
        starts.append(s)
        lat.append(e_ - s)
        estimate = sum(lat) / len(lat)
        index += 1
    end = starts[-1] + lat[-1]
    if trace and profiled is None:   # none crossed the deadline as estimated
        with profiling.Slice(cell.device) as prof_slice:
            cell.serve(index)
        profiled = index
    return dict(window_s=end - t0, latencies=lat, attempted=len(lat), failed=len(failed),
                failed_requests=failed, profiled=profiled, slice=prof_slice,
                program_spans=cell.program_spans if trace else None)


def warm_up(cell: Cell) -> float:
    """One request at the cell's shapes, outside the window's indices."""
    t0 = time.perf_counter()
    with recording(cell):
        cell.serve(-1)
    cell.recorder.records.pop(-1, None)
    cell.spans.by_request.pop(-1, None)
    cell.program_spans.pop(-1, None)
    return time.perf_counter() - t0


def check_sample(workload: dict, seed: int, completed: List[int]) -> List[int]:
    rng = np.random.default_rng(weights.derive_seed(seed, 2))
    n = min(workload["check"]["requests"], len(completed))
    return sorted(int(i) for i in rng.choice(completed, n, replace=False))


def records_of(cell: Cell, indices: List[int]) -> List[dict]:
    return [span for i in indices for span in cell.recorder.records[i]["spans"]]


def reference_values(cell: Cell) -> Dict[str, torch.Tensor]:
    """The run's weights, drawn again from the seed over the program's names
    and shapes."""
    return weights.fill(cell.specs, cell.seed, cell.device, getattr(torch, cell.config["dtype"]))


def reference_for(cell: Cell) -> check.Reference:
    """The reference on the cell's device with the run's weights."""
    return check.Reference(cell.config, cell.workload, reference_values(cell), cell.device)
