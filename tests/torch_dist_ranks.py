"""Rank-side code of the multi-rank CPU tests (tests/test_torch_dist.py,
test_torch_ring_attention.py, test_torch_partition.py,
test_torch_parallel_train.py). It imports torch and the port only, never
JAX: each function here runs in every rank of a spawned gloo world, and the
test in the parent holds what the ranks return against the JAX package.

``run_world(name, world, tmp_path, **kwargs)`` spawns `world` processes
that meet through ``file://<tmp_path>/rendezvous`` (so parallel test
workers never share a port), each with one thread, calls ``name(**kwargs)``
in each and returns the ranks' results, in rank order. A rank that raises
fails the call with its traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

WORLD_TIMEOUT_S = 240


def _main(name: str, rank: int, world: int, tmp: str, kwargs: Dict[str, Any]) -> None:
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        torch.set_num_threads(1)
        from spider_tpu_torch.common import dist

        dist.init_distributed_mode("cpu", init_method=f"file://{tmp}/rendezvous",
                                   world_size=world, rank=rank, timeout_s=WORLD_TIMEOUT_S)
        try:
            result = globals()[name](**kwargs)
        finally:
            dist.destroy()
        torch.save(result, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(name: str, world: int, tmp_path, **kwargs) -> List[Any]:
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(name, r, world, tmp, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORLD_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"rank{r}.pt.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def ring_cases(cases):
    """For each case (q, k, v, g as numpy [B, T, H, D] and causal): this
    rank's rows of the ring's output and of dq, dk, dv."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.ops.ring_attention import ring_attention
    from spider_tpu_torch.parallel.collectives import group_of

    mesh = dist.make_mesh(data=1, context=-1)
    group = group_of(mesh, ("context",))
    n, r = dist.get_world_size(), dist.get_rank()
    out = []
    for q, k, v, g, causal in cases:
        T = q.shape[1] // n
        local = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, r * T:(r + 1) * T]))
        ql, kl, vl = (local(a).requires_grad_(True) for a in (q, k, v))
        o = ring_attention(ql, kl, vl, group, causal=causal)
        o.backward(local(g))
        out.append(dict(out=o.detach(), dq=ql.grad, dk=kl.grad, dv=vl.grad))
    return out


def cp_llama_forward(params, ids):
    """The tiny Llama's logits of this context rank's rows of `ids`, with
    ring attention over a context group of the whole world."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import load_jax_params

    mesh = dist.make_mesh(data=1, context=-1)
    cfg = L.llama_tiny(vocab_size=64)
    model = load_jax_params(L.LlamaForCausalLM(cfg), params)
    model.replace_config(cfg.with_context_parallel(mesh))
    n, r = dist.get_world_size(), dist.get_rank()
    T = ids.shape[1] // n
    with torch.no_grad():
        logits, _, _ = model(input_ids=torch.from_numpy(ids[:, r * T:(r + 1) * T]))
    return logits


# ---------------------------------------------------------------------------
# the sharded LM train step
# ---------------------------------------------------------------------------

LM_OPT = dict(learning_rate=1e-2, grad_accum_steps=2, num_frozen_embed_rows=10)


def full_state(model) -> Dict[str, torch.Tensor]:
    """Every parameter as a whole tensor (DTensors gathered: collective)."""
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
            for n, p in model.named_parameters()}


def data_parallel_rows(batch, mesh) -> Dict[str, torch.Tensor]:
    """This data-parallel rank's rows of a global batch (B divisible by
    the data x fsdp size): the inverse of concatenating the ranks' batches."""
    from spider_tpu_torch.common import dist

    rank, size = dist.data_parallel_rank(mesh)
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        n = v.shape[0] // size
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def lm_train_steps(params, batches, meshes):
    """For each mesh of `meshes`: the tiny Llama from `params`, sharded
    (shard_model) and trained by make_lm_train_step on this rank's rows of
    each global batch; its metrics and final parameters."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import load_jax_params
    from spider_tpu_torch.runners import train_step as TS

    out = []
    for mesh_kw in meshes:
        mesh = dist.make_mesh(**mesh_kw)
        model = load_jax_params(L.LlamaForCausalLM(L.llama_tiny(vocab_size=64)), params)
        TS.shard_model(model, mesh)
        opt = TS.build_optimizer(params=dict(model.named_parameters()), **LM_OPT)
        step = TS.make_lm_train_step(model, opt)
        metrics = [{k: float(v) for k, v in step(data_parallel_rows(b, mesh)).items()}
                   for b in batches]
        out.append(dict(metrics=metrics, params=full_state(model)))
    return out


# ---------------------------------------------------------------------------
# placements, tensor parallelism, experts, the pipeline
# ---------------------------------------------------------------------------

def placement_key(placements) -> List:
    """[(kind, dim) per mesh dim]: comparable across processes."""
    return [(type(p).__name__, getattr(p, "dim", None)) for p in placements]


def placements_of(module) -> Dict[str, List]:
    """{name: placement_key} of every DTensor of `module`."""
    return {n: placement_key(t.placements)
            for n, t in list(module.named_parameters()) + list(module.named_buffers())
            if hasattr(t, "placements")}


def shard_llamas(params, params_int8, mesh_kw):
    """shard_params of the tiny Llama (fp and int8) over `mesh_kw`: the
    placements each tensor got, and its whole tensor gathered back."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import load_jax_params
    from spider_tpu_torch.parallel import partition

    mesh = dist.make_mesh(**mesh_kw)
    out = []
    for tree, quant in ((params, None), (params_int8, "int8")):
        import dataclasses

        cfg = dataclasses.replace(L.llama_tiny(vocab_size=64), quantization=quant)
        model = load_jax_params(L.LlamaForCausalLM(cfg), tree)
        before = {n: t.clone() for n, t in model.state_dict().items()}
        partition.shard_params(model, mesh)
        whole = {n: t.full_tensor() for n, t in model.state_dict().items()}
        out.append(dict(placements=placements_of(model),
                        same=all(torch.equal(whole[n], before[n]) for n in before)))
    return out


def tp_generate(params, ids, new_tokens):
    """Greedy tokens of the tiny Llama made tensor-parallel over a model
    axis of 2 ranks (parallelize_llama; data over the rest)."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import load_jax_params
    from spider_tpu_torch.models.decode import GenerateConfig, generate
    from spider_tpu_torch.parallel import partition

    mesh = dist.make_mesh(model=2)
    model = load_jax_params(L.LlamaForCausalLM(L.llama_tiny(vocab_size=64)), params)
    plan = partition.tensor_parallel_plan(model)
    partition.parallelize_llama(model, mesh["model"])
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        emb = model.embed(ids)
        out = generate(model, emb, torch.tensor([ids.shape[1]], dtype=torch.int32),
                       GenerateConfig(max_new_tokens=new_tokens))
    return dict(plan=plan, tokens=out["tokens"].numpy())


def tp_generate_int4(params, ids, new_tokens):
    """Greedy tokens of the tiny int4 Llama from `params` (an int4 JAX
    tree) made tensor-parallel over a model axis of the whole world, and
    the local shapes its o_proj and q_proj kept."""
    import dataclasses

    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import load_jax_params
    from spider_tpu_torch.models.decode import GenerateConfig, generate
    from spider_tpu_torch.parallel import partition

    mesh = dist.make_mesh(data=1, model=-1)
    cfg = dataclasses.replace(L.llama_tiny(vocab_size=64), quantization="int4")
    model = load_jax_params(L.LlamaForCausalLM(cfg), params)
    partition.parallelize_llama(model, mesh["model"])
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        out = generate(model, model.embed(ids), torch.tensor([ids.shape[1]], dtype=torch.int32),
                       GenerateConfig(max_new_tokens=new_tokens))
    attn = model.model.layers[0].self_attn
    return dict(tokens=out["tokens"].numpy(), o_q=tuple(attn.o_proj.kernel_q.shape),
                q_q=tuple(attn.q_proj.kernel_q.shape))


def expert_parallel(wg, w1, w2, x, g, cfg_kw):
    """moe_ffn_expert_parallel over an expert group of the whole world, the
    experts placed by the partition rules' mlp/w1, mlp/w2 rows (as the MoE
    Llama's layer holds them): this rank's tokens' outputs, the aux term,
    and the gradients of x, wg and this rank's experts under sum(out * g)
    + aux."""
    from torch.distributed.tensor import distribute_tensor

    from spider_tpu_torch.common import dist
    from spider_tpu_torch.parallel import partition
    from spider_tpu_torch.parallel.collectives import group_of
    from spider_tpu_torch.parallel.moe import MoEConfig, moe_ffn_expert_parallel

    mesh = dist.make_mesh(data=1, expert=-1)
    n, r = dist.get_world_size(), dist.get_rank()
    T = x.shape[0] // n
    cfg = MoEConfig(**cfg_kw)
    spec = dict(partition.LLAMA_RULES)
    place = lambda pat, a: distribute_tensor(
        torch.from_numpy(a), mesh,
        partition.placements(partition.spec_for(f"model/layers/mlp/{pat}", partition.LLAMA_RULES,
                                                a.ndim + 1)[1:], mesh)).requires_grad_(True)
    pw1, pw2 = place("w1", w1), place("w2", w2)
    pwg = torch.from_numpy(wg).requires_grad_(True)
    xl = torch.from_numpy(np.ascontiguousarray(x[r * T:(r + 1) * T])).requires_grad_(True)
    out, aux = moe_ffn_expert_parallel(dict(wg=pwg, w1=pw1, w2=pw2), xl, cfg,
                                       group_of(mesh, ("expert",)))
    (out * torch.from_numpy(g[r * T:(r + 1) * T])).sum().add(aux).backward()
    return dict(out=out.detach(), aux=aux.item(), dx=xl.grad, dwg=pwg.grad,
                dw1=pw1.grad.to_local(), dw2=pw2.grad.to_local(),
                w1_place=placement_key(pw1.placements))


def pipeline(ws, bs, x, g):
    """gpipe over a stage group of the whole world (stage s = rank s, the
    tanh(h W + b) stage of the JAX test): the outputs and this stage's
    gradients under sum(out * g)."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.parallel.collectives import group_of
    from spider_tpu_torch.parallel.pipeline import gpipe

    mesh = dist.make_mesh(data=1, model=-1)
    r = dist.get_rank()
    w = torch.from_numpy(ws[r]).requires_grad_(True)
    b = torch.from_numpy(bs[r]).requires_grad_(True)
    out = gpipe(lambda p, h: torch.tanh(h @ p[0] + p[1]), (w, b), torch.from_numpy(x),
                group_of(mesh, ("model",)))
    (out * torch.from_numpy(g)).sum().backward()
    return dict(out=out.detach(), dw=w.grad, db=b.grad)


# ---------------------------------------------------------------------------
# the bootstrap, logger, task; the long-context config through the twin
# ---------------------------------------------------------------------------

def basics(result_dir):
    """The mesh (data 2 x context 2), meshes the world cannot hold, the
    logger's cross-rank sums and save_result over every rank."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.common.logger import MetricLogger
    from spider_tpu_torch.tasks.base_task import BaseTask

    r, n = dist.get_rank(), dist.get_world_size()
    mesh = dist.make_mesh(data=2, context=2)
    errors = []
    for kw in (dict(data=8), dict(data=2, context=4), dict(data=3), dict(data=None, fsdp=3),
               dict(data=None, context=None)):
        try:
            dist.make_mesh(**kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    logger = MetricLogger()
    for i in range(r + 1):                      # rank r logs r + 1 values
        logger.update(loss=float(10 * r + i))
    logger.synchronize_between_processes()
    meter = logger.meters["loss"]
    merged = BaseTask().save_result([{"rank": r, "i": i} for i in range(2)], result_dir, "res")
    return dict(names=mesh.mesh_dim_names, shape=tuple(mesh.mesh.shape),
                device_type=mesh.device_type, coord=mesh.get_coordinate(),
                data_rank=dist.data_parallel_rank(mesh), context_rank=dist.context_rank(mesh),
                backend=__import__("torch").distributed.get_backend(), errors=errors,
                count=meter.count, total=meter.total, merged=merged, world=n)


class StubPipe:
    """A decoder's text conditioning for the tests: a fixed table row per
    caption length (the stub of tests/test_torch_train.py)."""

    def __init__(self, shape, seed):
        self.table = np.random.default_rng(seed).standard_normal((32,) + tuple(shape)).astype(
            np.float32)

    def __call__(self, prompt, return_prompts_only=True):
        return np.stack([self.table[len(p) % 32] for p in prompt])


def longctx_twin(cfg_path, out_dir, trainable, encoder, mesh, draws):
    """spider_longctx_train.py through the train entry (``train.main`` on
    --device cpu) over `mesh`, its tiny Spider given the JAX weights and the
    stub IMAGE pipe; the metrics rank 0 wrote, and the Questions of the
    first `draws` batches this rank's loaders draw."""
    import json

    from spider_tpu_torch import train as ttrain
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.datasets.utils.loaders import MultiIterLoader, batched
    from spider_tpu_torch.models.convert import load_jax_spider
    from spider_tpu_torch.tasks.base_task import BaseTask

    build = BaseTask.build_model

    def build_model(self, cfg, *, device):
        spider = load_jax_spider(build(self, cfg, device=device), trainable, encoder)
        spider.diffusion_pipes = {"IMAGE": StubPipe((77, 32), seed=1)}
        return spider

    BaseTask.build_model = build_model
    runner = ttrain.main([cfg_path, "--device", "cpu", "--options",
                          f"run.output_dir='{out_dir}'", f"run.mesh={mesh!r}",
                          "model.with_pipes=False"])
    metrics = None
    if dist.is_main_process():
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    cfg = Config.fromfile(cfg_path)
    datasets = runner.task.build_datasets(cfg, data_rank=dist.data_parallel_rank(runner.mesh)[0])
    loader = MultiIterLoader([batched(iter(e["dataset"]), e["batch_size"])
                              for e in datasets["train"].values()],
                             [e["sample_ratio"] for e in datasets["train"].values()],
                             seed=runner.seed)
    questions = [next(loader)["Question"] for _ in range(draws)]
    return dict(metrics=metrics, questions=questions,
                data_rank=dist.data_parallel_rank(runner.mesh),
                cp=runner.model.llm.config.context_mesh is not None,
                sharded=all(hasattr(p, "placements")
                            for n, p in runner.model.llm.named_parameters()
                            if "lora" in n))


def spider_image_steps(trainable, encoder, batches, val_batches, mesh, out_dir, run):
    """The tiny Spider (JAX weights, the stub IMAGE pipe) through RunnerBase
    over `mesh`: each step's train_step on this data-parallel rank's part of
    each batch (batches[i][data rank]), then ``eval_epoch`` over a val split
    of this rank's parts of `val_batches`; the whole batch's losses, the
    trainable parameters after the steps and the eval results."""
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models import factory as tF
    from spider_tpu_torch.models.convert import load_jax_spider
    from spider_tpu_torch.runners.runner import RunnerBase
    from spider_tpu_torch.tasks.base_task import BaseTask

    m = dist.make_mesh(**mesh)
    ts = load_jax_spider(tF.build_tiny_spider(device="cpu", with_pipes=False), trainable, encoder)
    ts.diffusion_pipes = {"IMAGE": StubPipe((77, 32), seed=1)}
    runner = RunnerBase(Config.fromdict(dict(run=dict(run, output_dir=out_dir))), None, ts, {},
                        "job", mesh=m)
    d = dist.data_parallel_rank(m)[0]
    losses = [runner.train_step(b[d]) for b in batches]
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
              for n, p in runner.optimizer.params.items()}
    runner.task = BaseTask()
    runner._loaders = {"val": iter([b[d] for b in val_batches])}
    return dict(losses=losses, params=params, val=runner.eval_epoch("val"))


def moe_kept_hooks(model, kept, mesh):
    """Forward hooks on every MoE layer that record how many of its top_k
    picks each of this rank's tokens kept ([N] int): the dispatch of the
    global batch's gating over `mesh` (the port's ``topk_gating``)."""
    from spider_tpu_torch.parallel import moe

    def hook(mod, inputs, _):
        cfg = mod.cfg
        x = inputs[0].detach()
        shards = moe.TokenShards.of(mesh)
        n = x.shape[0] * x.shape[1] * shards.dp_size * shards.cp_size
        cap = moe._capacity(n, cfg.num_experts, cfg.moe_capacity_factor, cfg.moe_top_k)
        logits = x.float() @ mod.wg.detach()
        _, dispatch, _ = moe.topk_gating(logits, cap, cfg.moe_top_k, shards)
        kept.append(dispatch.sum(dim=(1, 2)))

    return [layer.mlp.register_forward_hook(hook) for layer in model.model.layers]


def moe_llama_run(model, batch, mesh):
    """The MoE Llama's logits, aux terms and kept counts on this rank's
    tokens of `batch` (the whole batch without a mesh), then one
    make_lm_train_step on them: its metrics and the gradients the optimizer
    was handed, whole."""
    from spider_tpu_torch.runners import train_step as TS

    rows = batch if mesh is None else data_parallel_rows(batch, mesh)
    rows = {k: torch.as_tensor(v) for k, v in rows.items()}
    kept = []
    hooks = moe_kept_hooks(model, kept, mesh)
    with torch.no_grad():
        logits, _, _ = model(input_ids=model.shards.cut(rows["input_ids"]))
    for h in hooks:
        h.remove()
    aux = model.moe_aux_losses().detach().clone()
    opt = TS.build_optimizer(params=dict(model.named_parameters()), learning_rate=1e-2,
                             max_grad_norm=0.0)
    grads, real = {}, opt.step

    def capture(g):
        for n, t in g.items():          # the same order on every rank: collectives match
            if t is not None:
                grads[n] = (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()
        real(g)

    opt.step = capture
    metrics = {k: float(v) for k, v in TS.make_lm_train_step(model, opt)(rows).items()}
    return dict(logits=logits, aux=aux, kept=kept, metrics=metrics, grads=grads)


def moe_llama_world(params, batch, cases):
    """For each (mesh_kw, cfg_kw): the tiny MoE Llama with LoRA from
    `params` sharded over the mesh by shard_model, through moe_llama_run."""
    import dataclasses

    from spider_tpu_torch.common import dist
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import load_jax_params
    from spider_tpu_torch.runners import train_step as TS

    out = []
    for mesh_kw, cfg_kw in cases:
        mesh = dist.make_mesh(**mesh_kw)
        cfg = dataclasses.replace(L.llama_tiny(vocab_size=64, lora_r=2), **cfg_kw)
        model = load_jax_params(L.LlamaForCausalLM(cfg), params)
        TS.shard_model(model, mesh)
        res = moe_llama_run(model, batch, mesh)
        res["w1_place"] = placement_key(model.model.layers[0].mlp.w1.placements)
        out.append(res)
    return out


def tiny_vd(text, unet, vae):
    """The port's tiny ZeroScope pipeline with the JAX pipeline's weights."""
    from spider_tpu_torch.models.convert import load_jax_params
    from spider_tpu_torch.models.pipelines import vd
    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    pipe = vd.build_tiny_vd(tokenizer=TinyTokenizer(), device="cpu")
    for module, tree in ((pipe.text_encoder, text), (pipe.unet, unet), (pipe.vae, vae)):
        load_jax_params(module, tree)
    return pipe


def counted_unet_call(pipe, latents, cond, uncond, mesh):
    """The bytes this rank sends in one UNet3D call of the sharded denoise's
    first step, counted at the torch.distributed calls: all-to-all (the
    chunks that leave the rank), halo sends, all-reduced payloads."""
    import torch.distributed as tdist

    from spider_tpu_torch.parallel.collectives import group_of, rank_in, size_of

    cfg_group, sp_group = group_of(mesh, ("cfg",)), group_of(mesh, ("sp",))
    rows = 2 * latents.shape[0] // size_of(cfg_group)
    fl = latents.shape[1] // size_of(sp_group)
    c, s = rank_in(cfg_group), rank_in(sp_group)
    lat = torch.cat([latents, latents])[c * rows:(c + 1) * rows, s * fl:(s + 1) * fl]
    ctx = torch.cat([uncond, cond])[c * rows:(c + 1) * rows]
    counts = dict(all_to_all_bytes=0, halo_bytes=0, group_norm_bytes=0)
    real = tdist.all_to_all_single, tdist.batch_isend_irecv, tdist.all_reduce
    nbytes = lambda t: t.numel() * t.element_size()

    def all_to_all_single(out, x, group=None, **kw):
        n = tdist.get_world_size(group)
        counts["all_to_all_bytes"] += nbytes(x) * (n - 1) // n
        return real[0](out, x, group=group, **kw)

    def batch_isend_irecv(ops):
        counts["halo_bytes"] += sum(nbytes(op.tensor) for op in ops if op.op is tdist.isend)
        return real[1](ops)

    def all_reduce(t, *a, **kw):
        counts["group_norm_bytes"] += nbytes(t)
        return real[2](t, *a, **kw)

    from spider_tpu_torch.models import unet3d

    attention = unet3d.temporal_attention
    pixels = []

    def temporal_attention(q, k, v, heads, **kw):
        pixels.append((q.shape[2], kw.get("pixels")))     # (this rank's P, the routed P)
        return attention(q, k, v, heads, **kw)

    tdist.all_to_all_single, tdist.batch_isend_irecv, tdist.all_reduce = (
        all_to_all_single, batch_isend_irecv, all_reduce)
    unet3d.temporal_attention = temporal_attention
    try:
        with torch.inference_mode():
            pipe.unet(lat, torch.full((rows,), 981, dtype=torch.int32), ctx, sp_group=sp_group)
    finally:
        tdist.all_to_all_single, tdist.batch_isend_irecv, tdist.all_reduce = real
        unet3d.temporal_attention = attention
    return dict(counts, attention_pixels=pixels)


def video_world(weights, latents, cond, uncond, steps, meshes, prompt):
    """For each (cfg, sp) of `meshes`: the sharded denoise of `latents`
    (every rank's whole result), ``__call__(mesh=)``'s frames on the same
    latents, and the error a frame count that sp does not divide raises."""
    from spider_tpu_torch.common import dist

    pipe = tiny_vd(**weights)
    lat = torch.from_numpy(latents)
    out = []
    for cfg, sp in meshes:
        mesh = dist.make_video_mesh(cfg=cfg, sp=sp)
        run = pipe._denoise_fn_sharded(steps, 7.5, lat.shape, mesh)
        denoised = run(lat, torch.from_numpy(cond), torch.from_numpy(uncond))
        factor = 2 ** (len(pipe.vae.config.block_out_channels) - 1)
        frames = pipe(prompt=[prompt], num_inference_steps=steps, height=factor * lat.shape[2],
                      width=factor * lat.shape[3], num_frames=lat.shape[1], latents=lat,
                      mesh=mesh)
        try:
            pipe._denoise_fn_sharded(steps, 7.5, (1, sp + 1) + tuple(lat.shape[2:]), mesh)
            error = None
        except ValueError as e:
            error = str(e)
        sent = counted_unet_call(pipe, lat, torch.from_numpy(cond), torch.from_numpy(uncond),
                                 mesh)
        out.append(dict(denoised=denoised, frames=frames, error=error, sent=sent))
    return out


def train_world(lm, spider, twin):
    """The three training cases of tests/test_torch_parallel_train.py in one
    world: each a dict of the keyword arguments of its function."""
    return dict(lm=lm_train_steps(**lm), spider=spider_image_steps(**spider),
                twin=longctx_twin(**twin))


def partition_world(shard, tp, ep, pipe):
    """The multi-rank cases of tests/test_torch_partition.py in one world."""
    return dict(shard=shard_llamas(**shard), tp=tp_generate(**tp), ep=expert_parallel(**ep),
                pipe=pipeline(**pipe))


def ring_world(ring, cp):
    """The multi-rank cases of tests/test_torch_ring_attention.py."""
    return dict(ring=ring_cases(**ring), cp=cp_llama_forward(**cp))
