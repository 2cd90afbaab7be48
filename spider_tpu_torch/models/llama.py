"""Llama-family decoder in PyTorch (counterpart of spider_tpu/models/llama.py).

Submodule and parameter names follow the JAX parameter tree
(``embed_tokens``, ``model.layers.<i>.self_attn.q_proj``, ``lm_head``, ...)
so that ``convert.load_jax_params`` fills the port from JAX weights with one
generic walk. The JAX model stacks its layers under ``nn.scan``; here they
are an ``nn.ModuleList`` and the converter unstacks the layer axis.

Attention: prefill (T > 1) runs the flash kernel over the whole KV cache;
single-token decode over the contiguous cache is plain torch, as the
reference keeps it an XLA einsum; single-token decode over a block-paged
pool (``page_table`` given; serving/continuous.py) runs the paged decode
kernel. Caches and pools are updated IN PLACE (JAX returns new ones); every
call returns the cache it was given.

Parameters are stored in ``param_dtype`` and cast to ``dtype`` for compute.
``quantization='int8'`` stores each projection as int8 [out, in] plus a
per-output-channel fp32 scale applied to the matmul output. Eager PyTorch
makes a bf16 copy of each int8 weight on every call: correct, and slow; a
W8A16 kernel is later work. ``quantization='int4'`` packs two signed 4-bit
weights per byte, [out, in/2] (ops/quant.py has the layout), and runs the
int4 matmul kernel. ``lora.r > 0`` adds the additive LoRA branch to the
targeted projections; ``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), so the flash forward kernel runs twice there.
The cache-free forward is differentiable: its flash attention carries the
backward kernels.

The rest of the family, as in the JAX package: ``attention_bias`` (Qwen2:
a bias on q/k/v, none on o or the MLP); ``tie_word_embeddings`` (no
``lm_head``; the logits are the hidden state times the embedding matrix);
``mrope_section`` (Qwen2-VL's 3-D RoPE, taken when positions are
[3, B, T]); ``num_experts > 0`` (every MLP becomes the capacity-gated MoE
FFN of parallel/moe.py, ``LlamaMoEMLP``); ``context_mesh`` (context
parallelism: the cache-free training forward holds T / n consecutive rows
of each sequence on each rank of the mesh's ``context_axis`` and attends through
ops/ring_attention.py; its RoPE positions are global, rank r's rows start
at r * T_local).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from spider_tpu_torch.ops.attention import flash_attention, mha_reference
from spider_tpu_torch.ops.norms import rms_norm
from spider_tpu_torch.ops.paged_attention import paged_decode_attention
from spider_tpu_torch.ops.quant import int4_matmul
from spider_tpu_torch.ops.ring_attention import ring_attention
from spider_tpu_torch.ops.rope import apply_mrope, apply_rope, rope_inv_freq
from spider_tpu_torch.parallel.collectives import group_of, rank_in
from spider_tpu_torch.parallel.loss_shards import LOCAL, LossShards
from spider_tpu_torch.parallel.moe import MoEConfig, moe_ffn_sharded

KVCache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 0                      # 0 disables LoRA
    alpha: float = 21.0
    dropout: float = 0.0            # as in the reference: a field that nothing reads
    targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, float]] = None
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    lora: LoraConfig = dataclasses.field(default_factory=LoraConfig)
    remat: bool = False
    # 'int8' or 'int4': weight-only per-output-channel quantization of every
    # projection and the lm_head (embeddings and norms stay high precision).
    quantization: Optional[str] = None
    # Qwen2 family: bias on the q/k/v projections (o and the MLP stay
    # bias-free).
    attention_bias: bool = False
    # Qwen2-VL / Qwen2.5-Omni 3-D RoPE: head_dim/2 frequencies split over
    # the (temporal, height, width) position streams; taken when positions
    # are [3, B, T], plain RoPE otherwise.
    mrope_section: Optional[Tuple[int, ...]] = None
    # Mixture of experts: > 0 replaces every MLP with num_experts
    # capacity-gated experts (LlamaMoEMLP).
    num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    # Context parallelism: the ranks of `context_axis` of this DeviceMesh hold
    # consecutive pieces of each sequence (with_context_parallel); None is
    # one piece.
    context_mesh: Optional[object] = dataclasses.field(default=None, compare=False,
                                                       repr=False)
    context_axis: str = "context"

    def with_context_parallel(self, mesh, axis: str = "context") -> "LlamaConfig":
        return dataclasses.replace(self, context_mesh=mesh, context_axis=axis)

    @property
    def context_group(self):
        """The process group of this rank's context peers (None without)."""
        if self.context_mesh is None:
            return None
        return group_of(self.context_mesh, (self.context_axis,))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def extend_vocab(self, new_vocab_size: int) -> "LlamaConfig":
        return dataclasses.replace(self, vocab_size=new_vocab_size)


def llama2_7b() -> LlamaConfig:
    return LlamaConfig()


def llama3_8b() -> LlamaConfig:
    """DeepSeek-R1-Distill-Llama-8B shares this architecture."""
    return LlamaConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        max_position_embeddings=131072,
        rope_theta=500000.0,
        rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    )


def qwen2_7b() -> LlamaConfig:
    """Qwen2/2.5-7B (the Qwen2.5-Omni thinker's text decoder has this
    shape)."""
    return LlamaConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        max_position_embeddings=32768,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        attention_bias=True,
    )


def llama_tiny(vocab_size: int = 512, lora_r: int = 0) -> LlamaConfig:
    """Small config for CPU tests."""
    return LlamaConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=512,
        rope_theta=10000.0,
        dtype=torch.float32,
        lora=LoraConfig(r=lora_r),
    )


class LoraDense(nn.Module):
    """y = x W, with W either a float ``weight`` [out, in] or, under
    quantization='int8', ``kernel_q`` int8 [out, in] and ``kernel_scale``
    fp32 [out]: y = (x @ kernel_q.to(dtype)^T) * kernel_scale.to(dtype); or,
    under quantization='int4', ``kernel_q`` int8 [out, in/2] holding two
    signed nibbles a byte (in-rows i and i + in/2) and ``kernel_scale`` fp32
    [out]: y = int4_matmul(x, kernel_q, kernel_scale) in dtype, the scale on
    the fp32 accumulator. With use_bias, ``bias`` [out] in param_dtype is
    added in dtype after the scale, as the JAX module adds it. With
    lora_r > 0 it adds (alpha / r) x A B, ``lora_a`` [in, r] ~ N(0, 0.02)
    and ``lora_b`` [r, out] zeros, both fp32 whatever param_dtype is (they
    train while a bf16 base stays frozen)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 quantization: Optional[str] = None, device=None,
                 lora_r: int = 0, lora_alpha: float = 21.0, use_bias: bool = False):
        super().__init__()
        if quantization not in (None, "int8", "int4"):
            raise NotImplementedError(f"quantization={quantization!r} is not ported")
        if quantization == "int4" and in_features % 2:
            raise ValueError(f"int4 packs pairs of input rows; in_features={in_features}")
        self.dtype = dtype
        self.quantization = quantization
        if quantization in ("int8", "int4"):
            packed = in_features // 2 if quantization == "int4" else in_features
            self.register_buffer("kernel_q", torch.zeros(
                features, packed, dtype=torch.int8, device=device))
            self.register_buffer("kernel_scale", torch.ones(
                features, dtype=torch.float32, device=device))
        else:
            self.weight = nn.Parameter(torch.zeros(
                features, in_features, dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype, device=device))
                     if use_bias else None)
        self.lora_scale = lora_alpha / lora_r if lora_r > 0 else 0.0
        if lora_r > 0:
            self.lora_a = nn.Parameter(0.02 * torch.randn(
                in_features, lora_r, dtype=torch.float32, device=device))
            self.lora_b = nn.Parameter(torch.zeros(
                lora_r, features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantization == "int8":
            y = F.linear(x, self.kernel_q.to(self.dtype)) * self.kernel_scale.to(self.dtype)
        elif self.quantization == "int4":
            y = int4_matmul(x, self.kernel_q, self.kernel_scale, out_dtype=self.dtype)
        else:
            y = F.linear(x, self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.lora_scale:
            y = y + self.lora_scale * ((x @ self.lora_a.to(self.dtype))
                                       @ self.lora_b.to(self.dtype))
        return y


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 index: Union[int, torch.Tensor]) -> None:
    """cache [B, S, Hkv, D] <- new [B, T, Hkv, D] at row `index` (scalar,
    shared by the batch) or at per-sample rows index [B]. The start is
    clamped to [0, S - T] as jax.lax.dynamic_update_slice clamps it."""
    S, T = cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if not torch.is_tensor(index) or index.dim() == 0:
        i = min(max(int(index), 0), S - T)
        cache[:, i:i + T] = new
        return
    start = index.to(torch.long).clamp(0, S - T)
    rows = start[:, None] + torch.arange(T, device=cache.device)
    cache[torch.arange(cache.shape[0], device=cache.device)[:, None], rows] = new


def _write_pool(pool: torch.Tensor, new: torch.Tensor, page_table: torch.Tensor,
                index: Union[int, torch.Tensor]) -> None:
    """pool [N, page, Hkv, D] <- new [B, Hkv, D]: slot b's row goes to
    position index[b], that is block page_table[b, index[b] // page], row
    index[b] % page. A position whose logical page is at or past max_pages
    has no block, and its write is dropped, as JAX drops an out-of-range
    scatter (a torch index there would fault on the card). The dropped row
    writes back what its slot's last block already holds there, so the step
    needs no host sync."""
    B = new.shape[0]
    page, max_pages = pool.shape[1], page_table.shape[1]
    index = torch.as_tensor(index, device=pool.device).to(torch.long).reshape(-1).expand(B)
    logical = index // page
    blocks = page_table.gather(1, logical.clamp(max=max_pages - 1)[:, None])[:, 0].long()
    offs = index % page
    keep = (logical < max_pages)[:, None, None]
    pool[blocks, offs] = torch.where(keep, new.to(pool.dtype), pool[blocks, offs])


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.head_dim_
        H, Hq, Hkv = cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads

        def proj(name, i, o, use_bias=False):
            r = cfg.lora.r if name in cfg.lora.targets else 0
            return LoraDense(i, o, cfg.dtype, cfg.param_dtype, cfg.quantization, device,
                             lora_r=r, lora_alpha=cfg.lora.alpha, use_bias=use_bias)

        self.q_proj = proj("q_proj", H, Hq * D, cfg.attention_bias)
        self.k_proj = proj("k_proj", H, Hkv * D, cfg.attention_bias)
        self.v_proj = proj("v_proj", H, Hkv * D, cfg.attention_bias)
        self.o_proj = proj("o_proj", Hq * D, H)
        self.register_buffer("inv_freq", rope_inv_freq(D, cfg.rope_theta, cfg.rope_scaling,
                                                       device=device), persistent=False)

    def forward(self, x, positions, kv_write_index, kv_cache: Optional[KVCache] = None,
                kv_len: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None):
        cfg = self.cfg
        D, Hq, Hkv = cfg.head_dim_, cfg.num_attention_heads, cfg.num_key_value_heads
        B, T, _ = x.shape
        q = self.q_proj(x).reshape(B, T, Hq, D)
        k = self.k_proj(x).reshape(B, T, Hkv, D)
        v = self.v_proj(x).reshape(B, T, Hkv, D)
        if cfg.mrope_section is not None and positions.dim() == 3:
            q = apply_mrope(q, positions, self.inv_freq, cfg.mrope_section)
            k = apply_mrope(k, positions, self.inv_freq, cfg.mrope_section)
        else:
            q = apply_rope(q, positions, self.inv_freq)
            k = apply_rope(k, positions, self.inv_freq)
        if kv_cache is not None and page_table is not None:
            # Block-paged pool (serving): kv_cache is (pool_k, pool_v), each
            # [N_blocks, page, Hkv, D]; page_table [B, max_pages] maps each
            # slot's logical pages to pool blocks.
            if T != 1:
                raise ValueError(f"the paged path is single-token decode, got T={T}")
            pool_k, pool_v = kv_cache
            _write_pool(pool_k, k[:, 0], page_table, kv_write_index)
            _write_pool(pool_v, v[:, 0], page_table, kv_write_index)
            out = paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v, page_table,
                                         kv_len)
            return self.o_proj(out.reshape(B, T, Hq * D)), kv_cache
        if kv_cache is not None:
            ck, cv = kv_cache                    # [B, S_max, Hkv, D], updated in place
            _write_cache(ck, k, kv_write_index)
            _write_cache(cv, v, kv_write_index)
            ck, cv = ck.to(q.dtype), cv.to(q.dtype)   # no copy unless the cache's dtype differs
            if T == 1:
                # Single-token decode: plain attention over the cache.
                out = mha_reference(q, ck, cv, causal=False, kv_len=kv_len)
            else:
                out = flash_attention(q, ck, cv, causal=True, kv_len=kv_len,
                                      q_offset=kv_write_index)
        elif cfg.context_mesh is not None:
            out = ring_attention(q, k, v, cfg.context_group, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(B, T, Hq * D)), kv_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()

        def proj(name, i, o):
            r = cfg.lora.r if name in cfg.lora.targets else 0
            return LoraDense(i, o, cfg.dtype, cfg.param_dtype, cfg.quantization, device,
                             lora_r=r, lora_alpha=cfg.lora.alpha)

        self.gate_proj = proj("gate_proj", cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = proj("up_proj", cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = proj("down_proj", cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaMoEMLP(nn.Module):
    """The capacity-gated MoE FFN in place of LlamaMLP: parallel/moe.py's
    ``moe_ffn_sharded`` over ``mesh``, the training mesh that
    ``runners.train_step.shard_model`` sets, which gives this rank's tokens
    what ``moe_ffn_local`` gives them on the global batch and splits the
    experts over the mesh's ``expert`` axis; without a mesh the call's B*T
    tokens are the whole batch (``moe_ffn_local``'s result). Parameters as
    in the JAX tree: ``wg`` [H, E] fp32, ``w1`` [E, H, I] and ``w2`` [E, I, H] in
    param_dtype (under ``partition.parallelize_experts`` the expert rank's
    rows), cast to dtype for the products. Capacity uses
    ``moe_capacity_factor`` at inference too: the JAX module always calls
    ``moe_ffn_local`` with train=True.

    Each forward sets ``aux_loss`` (fp32 scalar, the load-balancing term)
    where the JAX module sows ``losses/moe_aux``;
    ``LlamaForCausalLM.moe_aux_losses`` stacks them."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        self.wg = nn.Parameter(torch.zeros(H, E, dtype=torch.float32, device=device))
        self.w1 = nn.Parameter(torch.zeros(E, H, I, dtype=cfg.param_dtype, device=device))
        self.w2 = nn.Parameter(torch.zeros(E, I, H, dtype=cfg.param_dtype, device=device))
        self.aux_loss: Optional[torch.Tensor] = None
        self.mesh = None

    def forward(self, x):
        cfg = self.cfg
        mcfg = MoEConfig(num_experts=cfg.num_experts, d_model=x.shape[-1],
                         d_ff=cfg.intermediate_size, capacity_factor=cfg.moe_capacity_factor,
                         top_k=cfg.moe_top_k, dtype=cfg.dtype)
        params = dict(wg=self.wg, w1=self.w1.to(cfg.dtype), w2=self.w2.to(cfg.dtype))
        out, self.aux_loss = moe_ffn_sharded(params, x, mcfg, self.mesh)
        return out


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = nn.Parameter(
            torch.ones(cfg.hidden_size, dtype=cfg.param_dtype, device=device))
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = nn.Parameter(
            torch.ones(cfg.hidden_size, dtype=cfg.param_dtype, device=device))
        self.mlp = (LlamaMoEMLP if cfg.num_experts > 0 else LlamaMLP)(cfg, device)

    def forward(self, x, positions, kv_write_index, kv_cache=None, kv_len=None,
                page_table=None):
        eps = self.cfg.rms_norm_eps
        attn_out, kv_cache = self.self_attn(rms_norm(x, self.input_layernorm, eps),
                                            positions, kv_write_index, kv_cache, kv_len,
                                            page_table)
        x = x + attn_out
        x = x + self.mlp(rms_norm(x, self.post_attention_layernorm, eps))
        return x, kv_cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(LlamaBlock(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size, dtype=cfg.param_dtype,
                                            device=device))

    def forward(self, inputs_embeds, positions, kv_write_index=0,
                kv_cache: Optional[KVCache] = None, kv_len=None,
                output_hidden_states: bool = False, page_table=None):
        """kv_cache: (k, v) each [L, B, S_max, Hkv, D] (init_kv_cache), or
        with page_table [B, max_pages] (k, v) pools each
        [L, N_blocks, page, Hkv, D] (init_paged_kv_cache)."""
        x = inputs_embeds.to(self.cfg.dtype)
        outs: List[torch.Tensor] = []
        for i, layer in enumerate(self.layers):
            layer_cache = None if kv_cache is None else (kv_cache[0][i], kv_cache[1][i])
            if self.cfg.remat and kv_cache is None and torch.is_grad_enabled():
                # Recompute the block in the backward pass; the cache-free
                # training forward only (a cache is updated in place).
                x = checkpoint(lambda h, layer=layer: layer(h, positions, kv_write_index)[0],
                               x, use_reentrant=False)
            else:
                x, _ = layer(x, positions, kv_write_index, layer_cache, kv_len, page_table)
            if output_hidden_states:
                outs.append(x)
        final = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        hidden_states = None
        if output_hidden_states:
            # HF convention: [embeds, layer_1..layer_{N-1} outputs, final norm].
            hidden_states = torch.stack(
                [inputs_embeds.to(self.cfg.dtype)] + outs[:-1] + [final], dim=0)
        return final, hidden_states, kv_cache


class LlamaForCausalLM(nn.Module):
    shards = LOCAL      # this rank's piece of a batch (train_step.shard_model sets it)

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.param_dtype, device=device)
        self.model = LlamaModel(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = LoraDense(cfg.hidden_size, cfg.vocab_size, cfg.dtype,
                                     cfg.param_dtype, cfg.quantization, device)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def replace_config(self, cfg: LlamaConfig) -> None:
        """Hand every module that reads the config a new one (a context
        group, or tensor parallelism's local head counts)."""
        self.config = cfg
        self.model.cfg = cfg
        for layer in self.model.layers:
            layer.cfg = layer.self_attn.cfg = cfg
            if hasattr(layer.mlp, "cfg"):
                layer.mlp.cfg = cfg

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.config.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[..., H] -> [..., V]: the lm_head, or with tied embeddings the
        hidden state times the embedding matrix, both in dtype."""
        if self.config.tie_word_embeddings:
            dtype = self.config.dtype
            return hidden.to(dtype) @ self.embed_tokens.weight.to(dtype).T
        return self.lm_head(hidden)

    def moe_aux_losses(self) -> Optional[torch.Tensor]:
        """[L] fp32: each MoE layer's load-balancing term from the last
        forward (the JAX model's sown ``losses/moe_aux``; under a training
        mesh the global batch's, alike on every rank); None without
        experts."""
        if self.config.num_experts <= 0:
            return None
        return torch.stack([layer.mlp.aux_loss for layer in self.model.layers])

    def _positions(self, inputs_embeds, positions, kv_write_index):
        if positions is not None:
            return positions
        T = inputs_embeds.shape[1]
        if self.config.context_mesh is not None:
            # rank r of the context group holds rows r*T .. (r+1)*T - 1
            kv_write_index = kv_write_index + rank_in(self.config.context_group) * T
        return (torch.arange(T, dtype=torch.int32, device=inputs_embeds.device)[None]
                + kv_write_index)

    def call_with_final(self, inputs_embeds, positions=None, kv_write_index=0,
                        kv_cache: Optional[KVCache] = None, kv_len=None):
        """(logits, final_hidden [B, T, H], kv_cache): the post-final-norm
        last layer (== hidden_states[-1]) without stacking every layer."""
        final, _, kv_cache = self.model(
            inputs_embeds, self._positions(inputs_embeds, positions, kv_write_index),
            kv_write_index, kv_cache, kv_len)
        return self.logits(final), final, kv_cache

    def forward(self, input_ids=None, inputs_embeds=None, positions=None,
                kv_write_index=0, kv_cache: Optional[KVCache] = None, kv_len=None,
                output_hidden_states: bool = False, page_table=None):
        """(logits [B,T,V], hidden_states [L+1,B,T,H] | None, kv_cache | None).

        page_table [B, max_pages]: block-paged decode; kv_cache is then
        (pool_k, pool_v), each [L, N_blocks, page, Hkv, D]."""
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        final, hidden_states, kv_cache = self.model(
            inputs_embeds, self._positions(inputs_embeds, positions, kv_write_index),
            kv_write_index, kv_cache, kv_len, output_hidden_states, page_table)
        return self.logits(final), hidden_states, kv_cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted LM loss and token accuracy. logits [B, T, V]; labels [B, T]
    with ignore_index outside answer spans. Log-softmax in fp32; both are
    divided by max(number of live targets, 1)."""
    return LOCAL.token_loss(logits, LossShards.shift(labels, ignore_index), ignore_index)


def init_kv_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
                  device=None, dtype: Optional[torch.dtype] = None) -> KVCache:
    """(k, v) each [L, B, max_len, Hkv, D] in `dtype` (cfg.dtype if None),
    zero-filled."""
    shape = (cfg.num_hidden_layers, batch_size, max_len, cfg.num_key_value_heads,
             cfg.head_dim_)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_paged_kv_cache(cfg: LlamaConfig, num_blocks: int, page: int = 128,
                        device=None) -> KVCache:
    """Block-paged KV pool: (k, v) each [L, num_blocks, page, Hkv, D] in
    cfg.dtype, zero-filled. Slots map logical pages to pool blocks through
    a host-managed page table (serving/continuous.py)."""
    shape = (cfg.num_hidden_layers, num_blocks, page, cfg.num_key_value_heads,
             cfg.head_dim_)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
