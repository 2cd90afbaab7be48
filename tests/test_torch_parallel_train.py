"""Sharded training (spider_tpu_torch/runners/{train_step,runner}.py and the
train entry under a mesh) against the port's single-process step and the
JAX package.

One 4-rank gloo world (tests/torch_dist_ranks.py::train_world) runs:
  * the tiny Llama's sharded LM step (FSDP2/HSDP over data 2 x fsdp 2,
    data 2 x context 2 through ring attention, and fsdp 2 x model 2: FSDP2
    over the tensor-parallel Llama), 4 calls at gradient
    accumulation 2 with 10 frozen vocabulary rows: each call's loss,
    accuracy and gradient norm against the port's one-process step on the
    concatenated global batch and against JAX's ``make_jitted_train_step``
    on it, the final parameters against the one-process ones, the frozen
    rows bit-equal;
  * the tiny Spider through ``RunnerBase`` over data 2 x context 2 on IMAGE
    batches (the aligner losses read hidden states gathered along the
    sequence and outputs gathered along the batch): its losses against the
    one-process runner on the global batch and the JAX Spider's, and its
    eval over a val split: the whole batch's values, alike on every rank,
    against the one-process runner's eval;
  * train_configs/spider_longctx_train.py's tiny preset through the train
    entry with run.mesh = data 2 x context 2: context peers draw the same
    batches, data ranks their own, and its losses equal the one-process
    runner's on the concatenated batches and, at the first step, the JAX
    runner's loss.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.common import dist as jdist
from spider_tpu.models import factory as jF
from spider_tpu.models import llama as jL
from spider_tpu.runners import train_step as jTS
from spider_tpu_torch import train as ttrain
from spider_tpu_torch.common.config import Config, apply_overrides
from spider_tpu_torch.datasets.utils.loaders import MultiIterLoader, batched
from spider_tpu_torch.models import factory as tF
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params, load_jax_spider
from spider_tpu_torch.runners import train_step as tTS
from spider_tpu_torch.runners.runner import RunnerBase
from spider_tpu_torch.tasks.base_task import BaseTask
from test_torch_spider_model import _numpy_tree
from torch_dist_ranks import LM_OPT, StubPipe, run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONGCTX = os.path.join(ROOT, "train_configs", "spider_longctx_train.py")
LM_MESHES = [dict(data=2, fsdp=2), dict(data=2, context=2), dict(fsdp=2, model=2)]
CP_MESH = dict(data=2, context=2)
SPIDER_RUN = dict(lr_sched="warmup_decay_lr", init_lr=1e-3, warmup_steps=2, max_epoch=1,
                  iters_per_epoch=4, weight_decay=0.05, max_grad_norm=0.5, accum_grad_iters=2,
                  num_frozen_embed_rows=300, length_bucket=32)
STEPS = 4


def _lm_params():
    m = jL.LlamaForCausalLM(jL.llama_tiny(vocab_size=64))
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    rng = np.random.default_rng(0)
    return m, jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _lm_batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, 64, (4, 16))
        labels = rng.integers(0, 64, (4, 16))
        labels[:, :3] = -100
        labels[0, 5:] = -100            # ranks hold different counts of live targets
        out.append(dict(input_ids=ids, labels=labels))
    return out


def _image_samples(i):
    caps = [f"a dog runs {i}", f"two red birds on a wire {i}"]
    rng = np.random.default_rng(100 + i)
    return {"Question": [f"make <IMAGE><IMAGE-Placeholder></IMAGE> like: {c}" for c in caps],
            "TaskPrompt": ["[IMAGE]"] * 2,
            "Answer": [f"<IMAGE>{c}<IMAGE-Placeholder></IMAGE>" for c in caps],
            "Caption": caps,
            "IMAGE": [rng.standard_normal((3, 2, 28, 28)).astype(np.float32) for _ in caps]}


def _concat(parts):
    return {k: [x for p in parts for x in p[k]] for k in parts[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    _, lm_params = _lm_params()
    js = jF.build_tiny_spider(with_pipes=False)
    jl = jF.build_tiny_spider(with_pipes=False, lora_r=32, max_context_len=2048)
    spider_batches = [[_image_samples(2 * i + r) for r in range(2)] for i in range(STEPS)]
    val_batches = [[_image_samples(50 + 2 * i + r) for r in range(2)] for i in range(2)]
    res = run_world(
        "train_world", 4, d / "world",
        lm=dict(params=lm_params, batches=_lm_batches(), meshes=LM_MESHES),
        spider=dict(trainable=_numpy_tree(js.trainable_params()),
                    encoder=_numpy_tree(js.encoder_params), batches=spider_batches,
                    val_batches=val_batches, mesh=CP_MESH, out_dir=str(d / "spider"), run=SPIDER_RUN),
        twin=dict(cfg_path=LONGCTX, out_dir=str(d / "twin"),
                  trainable=_numpy_tree(jl.trainable_params()),
                  encoder=_numpy_tree(jl.encoder_params), mesh=CP_MESH, draws=STEPS))
    return dict(res=res, lm_params=lm_params, js=js, jl=jl, spider_batches=spider_batches,
                val_batches=val_batches, dir=d)


# ---------------------------------------------------------------------------
# the LM step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_lm():
    _, params = _lm_params()
    model = load_jax_params(tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=64)), params)
    opt = tTS.build_optimizer(params=dict(model.named_parameters()), **LM_OPT)
    step = tTS.make_lm_train_step(model, opt)
    metrics = [{k: float(v) for k, v in step({k: torch.as_tensor(v) for k, v in b.items()})
                .items()} for b in _lm_batches()]
    return metrics, {n: p.detach() for n, p in model.named_parameters()}


def _jax_lm_losses(mesh_kw):
    model, params = _lm_params()
    tx = jTS.build_optimizer(LM_OPT["learning_rate"], grad_accum_steps=2,
                             num_frozen_embed_rows=10)
    mesh = jdist.make_mesh(**mesh_kw, devices=jax.devices()[:4])
    state = jTS.TrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree_util.tree_map(jnp.asarray, params),
                           opt_state=tx.init(params))
    state = jax.device_put(state, jax.tree_util.tree_map(
        lambda _: jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()), state))
    step = jTS.make_jitted_train_step(model, tx, mesh, state)
    out = []
    with mesh:
        for b in _lm_batches():
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("mi", range(len(LM_MESHES)),
                         ids=["-".join(f"{k}{v}" for k, v in m.items()) for m in LM_MESHES])
def test_sharded_lm_steps_equal_the_one_process_step(world, one_process_lm, mi):
    want, want_params = one_process_lm
    for res in world["res"]:
        got = res["lm"][mi]
        for i, (g, w) in enumerate(zip(got["metrics"], want)):
            for k in ("loss", "gen_acc", "grad_norm"):
                assert g[k] == pytest.approx(w[k], rel=2e-5, abs=1e-6), (i, k)
        for n, p in want_params.items():
            torch.testing.assert_close(got["params"][n], p, rtol=0, atol=5e-5, msg=n)


@pytest.mark.parametrize("mi", range(len(LM_MESHES)),
                         ids=["-".join(f"{k}{v}" for k, v in m.items()) for m in LM_MESHES])
def test_sharded_lm_steps_equal_jax_make_jitted_train_step(world, mi):
    want = _jax_lm_losses(LM_MESHES[mi])
    got = world["res"][0]["lm"][mi]["metrics"]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "gen_acc", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=2e-4, abs=1e-5), (i, k)


@pytest.mark.parametrize("mi", range(len(LM_MESHES)),
                         ids=["-".join(f"{k}{v}" for k, v in m.items()) for m in LM_MESHES])
def test_frozen_vocabulary_rows_stay_bit_equal_on_every_shard(world, mi):
    emb0 = torch.from_numpy(world["lm_params"]["params"]["embed_tokens"]["embedding"])
    head0 = torch.from_numpy(world["lm_params"]["params"]["lm_head"]["kernel"]).T
    for res in world["res"]:
        p = res["lm"][mi]["params"]
        assert torch.equal(p["embed_tokens.weight"][:10], emb0[:10])
        assert torch.equal(p["lm_head.weight"][:10], head0[:10])
        assert (p["embed_tokens.weight"][10:] - emb0[10:]).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# the Spider runner on IMAGE batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_spider(world, tmp_path_factory):
    """The one-process runner on the global batches: (its runner, the
    step losses)."""
    js = world["js"]
    ts = load_jax_spider(tF.build_tiny_spider(device="cpu", with_pipes=False),
                         _numpy_tree(js.trainable_params()), _numpy_tree(js.encoder_params))
    ts.diffusion_pipes = {"IMAGE": StubPipe((77, 32), seed=1)}
    out_dir = str(tmp_path_factory.mktemp("spider_one"))
    runner = RunnerBase(Config.fromdict(dict(run=dict(SPIDER_RUN, output_dir=out_dir))),
                        BaseTask(), ts, {}, "one")
    return runner, [runner.train_step(_concat(b)) for b in world["spider_batches"]]


def test_sharded_spider_runner_equals_the_one_process_runner(one_process_spider, world):
    runner, want = one_process_spider
    assert "IMAGE_semantic_align_mse_loss" in want[0]
    for res in world["res"]:
        got = res["spider"]["losses"]
        for i, (g, w) in enumerate(zip(got, want)):
            assert set(g) == set(w)
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-5), (i, k)
        for n, p in runner.optimizer.params.items():
            torch.testing.assert_close(res["spider"]["params"][n], p.detach(), rtol=0,
                                       atol=1e-4, msg=n)


def test_sharded_runner_eval_equals_the_one_process_eval(one_process_spider, world):
    """Under data 2 x context 2 each rank evaluates its piece through the
    context-parallel forward; every rank gets the whole batch's values, the
    one-process runner's on the concatenated val batches, so every rank
    takes the same branch at the best checkpoint."""
    runner, _ = one_process_spider
    runner._loaders = {"val": iter([_concat(b) for b in world["val_batches"]])}
    want = runner.eval_epoch("val")
    assert len(want) == 2 and "IMAGE_semantic_align_mse_loss" in want[0]
    got = [res["spider"]["val"] for res in world["res"]]
    assert all(g == got[0] for g in got)
    for i, (g, w) in enumerate(zip(got[0], want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-5), (i, k)


def _jax_spider_loss(js, samples, bucket, cond):
    from spider_tpu.models.spider import PreparedBatch
    from spider_tpu.runners.runner import _pad_to_bucket

    task = samples["TaskPrompt"][0][1:-1]
    batch = _pad_to_bucket(js.prepare_batch(samples), bucket, js.tokenizer.pad_token_id)
    emb = js.encode_modalities(batch)
    fn = jax.jit(lambda p, b, e, c: js.compute_loss(p, PreparedBatch(**b), e, c, task))
    return fn(js.trainable_params(), dataclasses.asdict(batch), emb,
              None if cond is None else jnp.asarray(cond))


def test_sharded_spider_runner_first_step_equals_the_jax_loss(world):
    samples = _concat(world["spider_batches"][0])
    want = _jax_spider_loss(world["js"], samples, 32,
                            StubPipe((77, 32), seed=1)(samples["Caption"]))
    got = world["res"][0]["spider"]["losses"][0]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5), k


# ---------------------------------------------------------------------------
# spider_longctx_train.py through the train entry
# ---------------------------------------------------------------------------

def test_context_peers_draw_the_same_batches_and_data_ranks_their_own(world):
    res = world["res"]
    assert [r["twin"]["data_rank"] for r in res] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert res[0]["twin"]["questions"] == res[1]["twin"]["questions"]
    assert res[2]["twin"]["questions"] == res[3]["twin"]["questions"]
    assert res[0]["twin"]["questions"] != res[2]["twin"]["questions"]
    assert all(r["twin"]["cp"] and r["twin"]["sharded"] for r in res)


@pytest.fixture(scope="module")
def one_process_twin(world, tmp_path_factory):
    """The config's runner without a mesh on the two data ranks' batches
    concatenated, on the JAX weights; (losses, the global batches)."""
    jl = world["jl"]
    cfg = apply_overrides(Config.fromfile(LONGCTX), [
        f"run.output_dir='{tmp_path_factory.mktemp('one')}'", "run.mesh={}",
        "model.with_pipes=False"])
    runner = ttrain.build_runner(cfg, torch.device("cpu"), "one")
    assert runner.mesh is None
    load_jax_spider(runner.model, _numpy_tree(jl.trainable_params()),
                    _numpy_tree(jl.encoder_params))
    runner.model.diffusion_pipes = {"IMAGE": StubPipe((77, 32), seed=1)}
    loaders = []
    for d in range(2):
        ds = runner.task.build_datasets(Config.fromfile(LONGCTX), data_rank=d)
        loaders.append(MultiIterLoader([batched(iter(e["dataset"]), e["batch_size"])
                                        for e in ds["train"].values()],
                                       [e["sample_ratio"] for e in ds["train"].values()],
                                       seed=runner.seed))
    batches = [_concat([next(l) for l in loaders]) for _ in range(STEPS)]
    return [runner.train_step(b) for b in batches], batches


def test_longctx_twin_losses_equal_the_one_process_run(world, one_process_twin):
    want, _ = one_process_twin
    got = world["res"][0]["twin"]["metrics"]
    assert [m["step"] for m in got] == list(range(1, STEPS + 1))
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-6), (i, k)
    assert world["res"][1]["twin"]["metrics"] is None      # rank 0 writes the stream


def test_longctx_twin_first_loss_equals_the_jax_runners(world, one_process_twin):
    _, batches = one_process_twin
    want = _jax_spider_loss(world["jl"], batches[0], 32, None)
    got = world["res"][0]["twin"]["metrics"][0]
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5), k
