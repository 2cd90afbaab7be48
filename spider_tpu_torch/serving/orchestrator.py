"""Multi-decoder stage orchestration (counterpart of
spider_tpu/serving/orchestrator.py).

Each task decoder (SD image, ZeroScope video, AudioLDM audio, ...) is a
stage with one worker thread, and a request's tag dispatches run on their
stages at once, so the request takes decode + max(stage) where the stages
overlap, in place of decode + sum(stages). On one card the stages share the
device: ``dryrun_concurrent`` gives each stage's thread its own CUDA stream
and measures, serially and concurrently, how much they overlap.
``SpiderFree`` keeps dispatching serially; the orchestrator is opt-in.

``StageOrchestrator`` and ``run_request_concurrent`` are a copy of the JAX
package's (pure Python).
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from spider_tpu_torch.models import tags as tags_mod


class StageOrchestrator:
    """Fan tag dispatches out to per-modality stage workers.

    decoders: modality -> callable, the same contract as SpiderDecoder's.
    Each modality gets ONE worker thread (a stage runs its own queue in
    order), and different stages overlap.
    """

    def __init__(self, decoders: Dict[str, Callable]):
        self.decoders = dict(decoders)
        self._pools = {m: ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"stage-{m}")
                       for m in self.decoders}

    def submit(self, modality: str, fn: Callable, *args, **kw) -> Future:
        return self._pools[modality].submit(fn, *args, **kw)

    def dispatch_all(self, spans: List[Tuple[str, Callable]]) -> List[Future]:
        """spans: [(modality, thunk)] in parse order; returns futures in the
        same order while the stages run concurrently."""
        return [self._pools[m].submit(thunk) for m, thunk in spans]

    def shutdown(self):
        for p in self._pools.values():
            p.shutdown(wait=False)


def run_request_concurrent(spider_decoder, samples: Dict[str, Any],
                           orchestrator: StageOrchestrator):
    """Parse samples['llm_text_all'][0] and dispatch every tag to its stage
    worker; returns (events in parse order, stage_latency dict). Each event
    is (modality, llm_text_res, preds). The whole call takes max(stage
    chains), not their sum."""
    output_texts = samples["llm_text_all"][0]
    modality_list = tags_mod.get_llm_text_modality(
        output_texts, list(spider_decoder.decode_modality.keys()))
    spans: List[Tuple[str, str]] = []
    for modality in modality_list:
        for llm_text_res in tags_mod.get_llm_text_res(output_texts, modality):
            spans.append((modality, llm_text_res))

    t_start = time.perf_counter()
    stage_done: Dict[str, float] = {}

    def thunk(modality, text_res):
        def run():
            s = dict(samples)
            s["llm_text_res"] = [text_res]
            preds = None
            if modality != "IMAGESTORY":
                preds = spider_decoder.decode_modality[modality](s)
            stage_done[modality] = time.perf_counter() - t_start
            return modality, text_res, preds
        return run

    results: List = []
    futures: List = []
    for m, t in spans:
        if m in orchestrator.decoders:
            futures.append(orchestrator.submit(m, thunk(m, t)))
            results.append(None)
        elif m == "IMAGESTORY":
            # no stage pool: the span goes out inline for the caller's story
            # pipeline (preds=None, as SpiderDecoder.generate_stream does)
            results.append((m, t, None))
        # spans without a decoder are dropped, as SpiderDecoder drops them
    it = iter(futures)
    results = [r if r is not None else next(it).result() for r in results]
    return results, stage_done


def _on_stream(fn: Callable, stream) -> Callable:
    """fn run with `stream` as the current CUDA stream (None: as it is),
    and finished on it before it returns, so its result is ready for any
    stream that reads it."""
    if stream is None:
        return fn

    def run(*args, **kw):
        import torch

        with torch.cuda.stream(stream):
            out = fn(*args, **kw)
        stream.synchronize()
        return out
    return run


def dryrun_concurrent(pipes: Optional[Dict[str, Callable]] = None, *, device="cuda",
                      repeats: int = 3, samples: Optional[Dict[str, Any]] = None):
    """One any-to-many request's decoder stages on one device, first one
    after another, then through ``run_request_concurrent`` with each stage on
    its own worker thread and, on a CUDA device, its own stream.

    pipes: modality -> fn(samples) -> media (tiny SD / ZeroScope / AudioLDM
    pipelines on `device` when None). The serial runs come first: they build
    what a first call caches (shared read-only tensors, scratch) before any
    thread starts, and with cold pipelines the first of them is slower, so
    take `repeats` of 2 or more. Returns dict(serial_s, concurrent_s,
    overlap_x, stages, serial_events, events, stage_s): the best of
    `repeats` seconds each way, the last serial and concurrent runs' events
    (modality, caption, media) and the seconds from the concurrent run's
    start at which each stage finished."""
    import torch

    device = torch.device(device)
    if pipes is None:
        pipes = _tiny_pipes(device)
    if samples is None:
        samples = {"llm_text_all": [
            "<IMAGE>a cat</IMAGE><VIDEO>a cat runs</VIDEO><AUDIO>a meow</AUDIO>"]}
    cuda = device.type == "cuda"
    streams = {m: torch.cuda.Stream(device) if cuda else None for m in pipes}
    staged = {m: _on_stream(fn, streams[m]) for m, fn in pipes.items()}

    class _Dec:
        decode_modality = staged

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def serial():
        # the same spans in the same order as the concurrent run
        out = []
        text = samples["llm_text_all"][0]
        for m in tags_mod.get_llm_text_modality(text, list(staged)):
            for cap in tags_mod.get_llm_text_res(text, m):
                out.append((m, cap, staged[m](dict(samples, llm_text_res=[cap]))))
        return out

    orch = StageOrchestrator(staged)
    try:
        serial_s, conc_s = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            serial_events = serial()
            sync()
            serial_s.append(time.perf_counter() - t0)
        for _ in range(repeats):
            t0 = time.perf_counter()
            events, stage_s = run_request_concurrent(_Dec(), samples, orch)
            sync()
            conc_s.append(time.perf_counter() - t0)
    finally:
        orch.shutdown()
    stats = dict(serial_s=min(serial_s), concurrent_s=min(conc_s),
                 overlap_x=min(serial_s) / min(conc_s), stages=len(pipes),
                 serial_events=serial_events, events=events, stage_s=stage_s)
    print(f"dryrun_concurrent: {stats['stages']}-stage any-to-many request "
          f"serial={stats['serial_s']:.4f}s concurrent={stats['concurrent_s']:.4f}s "
          f"({stats['overlap_x']:.2f}x overlap) on {device}")
    return stats


def _tiny_pipes(device) -> Dict[str, Callable]:
    """Tiny random SD / ZeroScope / AudioLDM stages on `device`, 4 steps."""
    from spider_tpu_torch.models.pipelines.ad import build_tiny_ad
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

    sd = build_tiny_sd(device=device, seed=1)
    vd = build_tiny_vd(device=device, seed=2)
    ad = build_tiny_ad(device=device, seed=3)

    def seeded(pipe, seed, **kw):
        import torch

        def fn(s):
            g = torch.Generator(device=device).manual_seed(seed)
            return pipe(prompt=s["llm_text_res"], num_inference_steps=4, generator=g, **kw)
        return fn

    return {"IMAGE": seeded(sd, 1), "VIDEO": seeded(vd, 2, height=32, width=32, num_frames=4),
            "AUDIO": seeded(ad, 3, audio_length_in_s=0.5)}
