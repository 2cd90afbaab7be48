"""Autoregressive generation: one prefill over the prompt, then a Python
loop over one static-shape single-token step (counterpart of
spider_tpu/models/decode.py, whose loop is a ``lax.scan``).

Every step keeps the batch shape and writes the KV cache in place, so no
step allocates a new cache and the loop holds no host synchronisation.
``stream_generate`` is the batch-1 chat form that hands out each token as it
is decoded (one host read a token).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from spider_tpu_torch.models.llama import LlamaForCausalLM, init_kv_cache
from spider_tpu_torch.ops.sampling import greedy, sample_top_p


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0          # 0 => greedy
    top_p: float = 1.0
    eos_ids: Tuple[int, ...] = ()     # stop tokens ([END], eos)
    pad_id: int = 0
    collect_layers: Tuple[int, ...] = (-1,)  # hidden-state layers to retain


def _sample(logits: torch.Tensor, gen_cfg: GenerateConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if gen_cfg.temperature <= 0.0:
        return greedy(logits)
    return sample_top_p(logits, generator, temperature=gen_cfg.temperature,
                        top_p=gen_cfg.top_p)


@torch.inference_mode()
def generate(model: LlamaForCausalLM, inputs_embeds: torch.Tensor,
             prompt_len: torch.Tensor, gen_cfg: GenerateConfig,
             generator: Optional[torch.Generator] = None,
             embed_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Generate tokens from (right-padded) prompt embeddings.

    Args:
      inputs_embeds: [B, T_prompt, H] prompt embeddings.
      prompt_len: [B] int32 true prompt lengths (<= T_prompt).
      embed_fn: token ids [B, 1] -> embeddings [B, 1, H] of each step's
        input; defaults to the model's embedding table.
      generator: the only source of randomness when temperature > 0;
        None means a generator seeded with 0, as the JAX package defaults
        to PRNGKey(0).
    Returns dict with tokens [B, N], step_hidden [N-1, K, B, H]
    (K = collected layers), done [B], kv_len [B] and cache.
    """
    cfg = model.config
    B, T_prompt, _ = inputs_embeds.shape
    N = gen_cfg.max_new_tokens
    device = inputs_embeds.device
    prompt_len = prompt_len.to(device=device, dtype=torch.int32)
    if generator is None and gen_cfg.temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(0)
    if embed_fn is None:
        embed_fn = model.embed
    cache = init_kv_cache(cfg, B, T_prompt + N, device=device)

    # ---- prefill: the cache is zero beyond each prompt; kv_len masks it off.
    positions = torch.arange(T_prompt, dtype=torch.int32, device=device)[None]
    logits, _, cache = model(inputs_embeds=inputs_embeds, positions=positions,
                             kv_write_index=0, kv_cache=cache, kv_len=prompt_len)
    last_idx = (prompt_len - 1).clamp_min(0).long()
    last_logits = logits[torch.arange(B, device=device), last_idx]     # [B, V]

    eos = (torch.tensor(gen_cfg.eos_ids, dtype=torch.int32, device=device)
           if gen_cfg.eos_ids else None)

    def is_eos(tok):
        if eos is None:
            return torch.zeros_like(tok, dtype=torch.bool)
        return (tok[:, None] == eos[None, :]).any(dim=-1)

    tok = _sample(last_logits, gen_cfg, generator)
    done = is_eos(tok)
    kv_len = prompt_len
    pad = torch.tensor(gen_cfg.pad_id, dtype=torch.int32, device=device)
    toks = [tok]
    hiddens = []
    for _ in range(max(N - 1, 0)):
        emb = embed_fn(tok[:, None].long())                             # [B, 1, H]
        logits, hidden, cache = model(
            inputs_embeds=emb, positions=kv_len[:, None], kv_write_index=kv_len,
            kv_cache=cache, kv_len=kv_len + 1, output_hidden_states=True)
        hiddens.append(torch.stack([hidden[i][:, 0] for i in gen_cfg.collect_layers]))
        nxt = torch.where(done, pad, _sample(logits[:, -1], gen_cfg, generator))
        new_done = done | is_eos(nxt)
        toks.append(nxt)
        kv_len = kv_len + (~done).to(torch.int32)
        tok, done = nxt, new_done

    # step_hidden[i] is the hidden state computed AT the position of
    # tokens[:, i] (its embedding was the step input); the last token gets
    # none, as in the JAX package.
    H = inputs_embeds.shape[-1]
    step_hidden = (torch.stack(hiddens) if hiddens else
                   torch.zeros((0, len(gen_cfg.collect_layers), B, H), dtype=cfg.dtype,
                               device=device))
    return dict(tokens=torch.stack(toks, dim=1), step_hidden=step_hidden, done=done,
                kv_len=kv_len, cache=cache)


def make_generate_fn(model: LlamaForCausalLM, gen_cfg: GenerateConfig):
    """``generate`` closed over the model and the config:
    fn(inputs_embeds, prompt_len, generator=None) -> generate's dict."""

    def fn(inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
           generator: Optional[torch.Generator] = None):
        return generate(model, inputs_embeds, prompt_len, gen_cfg, generator)

    return fn


def stream_generate(model: LlamaForCausalLM, inputs_embeds: torch.Tensor,
                    prompt_len: torch.Tensor, gen_cfg: GenerateConfig,
                    generator: Optional[torch.Generator] = None) -> Iterator[int]:
    """Token-streaming decode at batch 1: yields each token id as an int the
    moment it is decoded, up to max_new_tokens, and stops after an eos id.
    The same prefill and single-token step as ``generate``, which draws its
    samples from `generator` in the same order, so the stream equals
    ``generate``'s tokens (greedy, or sampled from equally seeded
    generators) up to the first eos."""
    B, T_prompt, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError(f"streaming is a batch-1 chat path, got batch {B}")
    cfg = model.config
    N = gen_cfg.max_new_tokens
    device = inputs_embeds.device
    kv_len = prompt_len.to(device=device, dtype=torch.int32).reshape(1)
    if generator is None and gen_cfg.temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(0)
    eos = set(gen_cfg.eos_ids)
    with torch.inference_mode():
        cache = init_kv_cache(cfg, 1, T_prompt + N, device=device)
        positions = torch.arange(T_prompt, dtype=torch.int32, device=device)[None]
        logits, _, cache = model(inputs_embeds=inputs_embeds, positions=positions,
                                 kv_write_index=0, kv_cache=cache, kv_len=kv_len)
        tok = _sample(logits[:, (kv_len - 1).clamp_min(0).long()[0]], gen_cfg, generator)
    for i in range(N):
        t = int(tok[0])
        yield t
        if t in eos or i == N - 1:
            return
        with torch.inference_mode():
            logits, _, cache = model(inputs_embeds=model.embed(tok[:, None].long()),
                                     positions=kv_len[:, None], kv_write_index=kv_len,
                                     kv_cache=cache, kv_len=kv_len + 1)
            tok = _sample(logits[:, -1], gen_cfg, generator)
        kv_len = kv_len + 1
