"""The port's training stack against the JAX package on the CPU: schedules,
the optimizer over several steps, the runner with checkpoint and resume, and
the copied data modules.

Weights come from the JAX modules as numpy through the converters; token ids,
samples and conditioning targets are made with numpy from a seed; fp32 at
tiny widths. Parameter parity after optimizer steps is held to 2% of one
step's largest possible movement (Adam moves a parameter by at most ~lr a
step, and divides by sqrt(v) + 1e-8, which magnifies summation-order noise on
elements whose gradient is itself noise); with lr = 1e-3 that is 2e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spider_tpu.common import optims as jO
from spider_tpu.models import factory as jF
from spider_tpu.models import llama as jL
from spider_tpu.models import spider as jS
from spider_tpu.models import tokenizer as jT
from spider_tpu.runners import train_step as jTS
from spider_tpu_torch import train as ttrain
from spider_tpu_torch.common import optims as tO
from spider_tpu_torch.common.config import Config
from spider_tpu_torch.models import factory as tF
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models import tokenizer as tT
from spider_tpu_torch.models.convert import (load_jax_params, load_jax_spider,
                                             spider_trainable_to_jax, to_jax_tree)
from spider_tpu_torch.runners import train_step as tTS
from spider_tpu_torch.models.spider import pad_to_bucket
from spider_tpu_torch.runners.runner import RunnerBase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CFG = os.path.join(ROOT, "train_configs", "spider_demo_train.py")
LR = 1e-3
PARAM_ATOL = 0.02 * LR


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("warmup_decay_lr", dict(init_lr=1e-3, warmup_steps=5, total_steps=16, min_lr=1e-5)),
    ("linear_warmup_cosine_lr", dict(init_lr=1e-3, min_lr=1e-5, warmup_steps=4,
                                     total_steps=15, warmup_start_lr=1e-6)),
    ("linear_warmup_step_lr", dict(init_lr=1e-3, min_lr=5e-4, warmup_steps=3, decay_rate=0.8,
                                   steps_per_epoch=4)),
])
def test_schedules_equal_the_optax_ones_over_20_steps(name, kw):
    js, ts = jO.build_schedule(name, **kw), tO.build_schedule(name, **kw)
    for step in range(20):
        # the optax schedule evaluates in fp32, the port's in Python floats
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-5, abs=1e-12), step
    with pytest.raises(KeyError):
        tO.build_schedule("no_such_schedule")


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _assert_trees_close(got, want, atol):
    got_flat = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    want_flat = {jax.tree_util.keystr(p): v for p, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got_flat) == set(want_flat)
    for key, w in want_flat.items():
        np.testing.assert_allclose(np.asarray(got_flat[key]), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=key)


OPT = dict(weight_decay=0.05, max_grad_norm=0.5, grad_accum_steps=2, num_frozen_embed_rows=300)


def test_four_lm_optimizer_steps_end_at_the_jax_parameters():
    vocab = 512
    jm = jL.LlamaForCausalLM(jL.llama_tiny(vocab_size=vocab, lora_r=4))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    tm = load_jax_params(tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=vocab, lora_r=4)), params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    sched = dict(init_lr=LR, warmup_steps=2, total_steps=6)
    tx = jTS.build_optimizer(jO.warmup_decay_lr(**sched), **OPT)
    state = jTS.TrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree_util.tree_map(jnp.asarray, params),
                           opt_state=tx.init(params))
    jstep = jax.jit(jTS.make_lm_train_step(jm, tx))
    opt = tTS.build_optimizer(tO.warmup_decay_lr(**sched), params=dict(tm.named_parameters()),
                              **OPT)
    tstep = tTS.make_lm_train_step(tm, opt)
    for i in range(8):                     # 8 calls = 4 updates at accumulation 2
        ids = rng.integers(3, vocab, size=(2, 12))
        labels = ids.copy()
        labels[:, :5] = -100
        state, jmet = jstep(state, dict(input_ids=jnp.asarray(ids), labels=jnp.asarray(labels)))
        tmet = tstep(dict(input_ids=torch.from_numpy(ids), labels=torch.from_numpy(labels)))
        for k in ("loss", "gen_acc", "grad_norm"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=2e-4, abs=1e-5), (i, k)
    assert opt.count == 4 and opt.mini_step == 0
    _assert_trees_close(to_jax_tree(tm), _numpy_tree(state.params)["params"], PARAM_ATOL)
    # the steps moved what trains, and not the frozen vocabulary rows
    for name in ("embed_tokens.weight", "lm_head.weight"):
        p = dict(tm.named_parameters())[name].detach()
        assert torch.equal(p[:300], before[name][:300]), name
        assert (p[300:] - before[name][300:]).abs().max() > LR, name
    assert (tm.model.norm.detach() - before["model.norm"]).abs().max() > LR


class _StubPipe:
    def __init__(self, shape, seed):
        self.table = np.random.default_rng(seed).standard_normal((32,) + shape).astype(
            np.float32)

    def __call__(self, prompt, return_prompts_only=True):
        return np.stack([self.table[len(p) % 32] for p in prompt])


def _image_samples(i):
    caps = [f"a dog runs {i}", f"two red birds on wire {i}"]
    rng = np.random.default_rng(100 + i)
    return {"Question": [f"make <IMAGE><IMAGE-Placeholder></IMAGE> like: {c}" for c in caps],
            "TaskPrompt": ["[IMAGE]"] * 2,
            "Answer": [f"<IMAGE>{c}<IMAGE-Placeholder></IMAGE>" for c in caps],
            "Caption": caps,
            "IMAGE": [rng.standard_normal((3, 2, 28, 28)).astype(np.float32) for _ in caps]}


def _run_cfg(tmp_path, **run):
    base = dict(lr_sched="warmup_decay_lr", init_lr=LR, warmup_steps=2, max_epoch=1,
                iters_per_epoch=6, weight_decay=0.05, max_grad_norm=0.5, accum_grad_iters=2,
                num_frozen_embed_rows=300, length_bucket=32, output_dir=str(tmp_path))
    base.update(run)
    return Config.fromdict(dict(run=base))


def test_four_spider_optimizer_steps_end_at_the_jax_parameters(tmp_path):
    pipes = {"IMAGE": _StubPipe((77, 32), seed=1)}
    js = jF.build_tiny_spider(with_pipes=False)
    js.diffusion_pipes = pipes
    tree = _numpy_tree(js.trainable_params())
    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    ts.diffusion_pipes = dict(pipes)
    load_jax_spider(ts, tree, _numpy_tree(js.encoder_params))
    runner = RunnerBase(_run_cfg(tmp_path), None, ts, {}, "job")

    tx = jTS.build_optimizer(jO.warmup_decay_lr(init_lr=LR, warmup_steps=2, total_steps=6),
                             weight_decay=0.05, max_grad_norm=0.5, grad_accum_steps=2,
                             num_frozen_embed_rows=300)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    pad_id = js.tokenizer.pad_token_id

    @jax.jit
    def jitted(params, opt_state, batch_dict, emb, cond):
        # the body of the reference runner's jitted step, without its mesh
        batch = jS.PreparedBatch(**batch_dict)

        def loss_fn(p):
            out = js.compute_loss(p, batch, emb, cond, "IMAGE")
            return out["loss"], out

        grads, out = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, out

    def jax_step(params, opt_state, samples):
        from spider_tpu.runners.runner import _pad_to_bucket as jpad

        batch = jpad(js.prepare_batch(samples), 32, pad_id)
        return jitted(params, opt_state, dataclasses.asdict(batch),
                      js.encode_modalities(batch),
                      jnp.asarray(pipes["IMAGE"](samples["Caption"])))

    for i in range(8):
        samples = _image_samples(i)
        params, opt_state, jout = jax_step(params, opt_state, samples)
        tout = runner.train_step(samples)
        assert set(tout) == set(jout)
        for k in jout:
            assert tout[k] == pytest.approx(float(jout[k]), rel=2e-4, abs=1e-4), (i, k)
    assert runner.global_step == 8 and runner.optimizer.count == 4
    _assert_trees_close(spider_trainable_to_jax(ts), _numpy_tree(params), PARAM_ATOL)


def test_frozen_rows_and_parameters_outside_the_patterns_do_not_move(tmp_path):
    # The reference wraps its chain in optax.masked, which hands a masked-out
    # leaf's raw gradient through as its update; here such a parameter is
    # bit-identical after the steps, weight decay and all.
    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    ts.diffusion_pipes = {"IMAGE": _StubPipe((77, 32), seed=1)}
    with torch.no_grad():
        for n, p in ts.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0, 0.05)
    before = {n: p.detach().clone() for n, p in ts.named_parameters()}
    patterns = (r"lora_", r"embed_tokens", r"lm_head", r"aligners/IMAGE/model")
    runner = RunnerBase(_run_cfg(tmp_path, accum_grad_iters=1, trainable_patterns=patterns),
                        None, ts, {}, "job")
    for i in range(3):
        out = runner.train_step(_image_samples(i))
        assert np.isfinite(out["loss"])
    moved, held = 0, 0
    for n, p in ts.named_parameters():
        inside = any(pat.replace("/", ".") in n for pat in patterns)
        if not inside:
            assert torch.equal(p.detach(), before[n]), n
            assert not p.requires_grad or n.startswith("encoder.")
            held += 1
        elif n.endswith(("embed_tokens.weight", "lm_head.weight")):
            assert torch.equal(p.detach()[:300], before[n][:300]), n
            assert not torch.equal(p.detach()[300:], before[n][300:]), n
        else:
            assert not torch.equal(p.detach(), before[n]), n
            moved += 1
    assert moved >= 16 and held > 50
    assert set(runner.optimizer.params) == {n for n in before if any(
        pat.replace("/", ".") in n for pat in patterns)}


def test_optimizer_details():
    # clip: max_norm / max(norm, max_norm); a gradient inside the norm passes
    p = {"w": torch.nn.Parameter(torch.tensor([1.0, -2.0]))}
    opt = tTS.build_optimizer(0.1, params=p, max_grad_norm=10.0, weight_decay=0.0)
    opt.step({"w": torch.tensor([3.0, 4.0])})
    # first Adam step moves every element by lr * sign(g) (bias-corrected)
    torch.testing.assert_close(p["w"].detach(), torch.tensor([0.9, -2.1]), atol=1e-6, rtol=0)
    # a parameter without a gradient still decays, as under optax.adamw
    q = {"w": torch.nn.Parameter(torch.tensor([1.0]))}
    tTS.build_optimizer(0.1, params=q, weight_decay=0.5).step({})
    torch.testing.assert_close(q["w"].detach(), torch.tensor([0.95]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the runner on the demo config: finite losses, checkpoint, resume
# ---------------------------------------------------------------------------

def _train_demo(out_dir, *extra):
    return ttrain.main([DEMO_CFG, "--device", "cpu", "--options",
                        f"run.output_dir={out_dir}", "run.iters_per_epoch=2",
                        "run.max_epoch=2", "run.weight_decay=0.01", *extra])


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_runner_trains_checkpoints_and_resumes_to_the_same_losses(tmp_path):
    whole = _train_demo(str(tmp_path / "whole"))
    rows = _metrics(str(tmp_path / "whole"))
    assert whole.global_step == 4 and [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["lr"] > 0 for r in rows)
    assert os.path.exists(tmp_path / "whole" / "checkpoint_0.pt")
    assert os.path.exists(tmp_path / "whole" / "checkpoint_1.pt")
    assert next(whole.model.parameters()).device.type == "cpu"

    # the same run cut after its first epoch ...
    first = _train_demo(str(tmp_path / "cut"), "run.max_epoch=2")
    ckpt = str(tmp_path / "whole" / "checkpoint_0.pt")
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 2 and state["epoch"] == 0
    assert set(state["params"]) == set(first.optimizer.params)
    assert state["opt_state"]["count"] == 2

    # ... and resumed from the epoch-0 checkpoint. The data stream is not part
    # of a checkpoint (nor is it in the reference): skip the two batches the
    # first epoch drew.
    cfg = Config.fromfile(DEMO_CFG)
    cfg.run.update(output_dir=str(tmp_path / "resumed"), iters_per_epoch=2, max_epoch=2,
                   weight_decay=0.01, resume_ckpt_path=ckpt)
    runner = ttrain.build_runner(cfg, torch.device("cpu"), "resumed")
    assert type(runner) is RunnerBase and runner.global_step == 0
    for _ in range(2):
        next(runner.dataloaders["train"])
    runner.train()
    assert runner.start_epoch == 1 and runner.global_step == 4
    for n, t in state["opt_state"]["mu"].items():
        assert runner.optimizer.mu[n].shape == t.shape
    resumed = _metrics(str(tmp_path / "resumed"))
    assert [r["step"] for r in resumed] == [3, 4]
    for got, want in zip(resumed, rows[2:]):
        assert got["lr"] == want["lr"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    for (n, p), (_, q) in zip(runner.model.named_parameters(), whole.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-7, msg=n)


def test_load_checkpoint_restores_step_epoch_params_and_optimizer_state(tmp_path):
    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    runner = RunnerBase(_run_cfg(tmp_path / "a", accum_grad_iters=2), None, ts, {}, "a")
    for i in range(3):                      # 3 calls: one update, one pending micro step
        runner.train_step(_image_samples(i))
    path = runner.save_checkpoint(epoch=4)
    other = RunnerBase(_run_cfg(tmp_path / "b", accum_grad_iters=2), None,
                       tF.build_tiny_spider(device="cpu", with_pipes=False, seed=9), {}, "b")
    other.load_checkpoint(path)
    assert (other.global_step, other.start_epoch) == (3, 5)
    assert (other.optimizer.count, other.optimizer.mini_step) == (1, 1)
    for n, p in runner.optimizer.params.items():
        assert torch.equal(other.optimizer.params[n].detach(), p.detach()), n
        for mine, theirs in ((other.optimizer.mu, runner.optimizer.mu),
                             (other.optimizer.nu, runner.optimizer.nu),
                             (other.optimizer.acc, runner.optimizer.acc)):
            assert torch.equal(mine[n], theirs[n]), n
    assert os.path.exists(runner.save_checkpoint_best(epoch=4))


def test_sigterm_saves_a_checkpoint_and_exits_143(tmp_path):
    import signal

    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    runner = RunnerBase(_run_cfg(tmp_path, accum_grad_iters=1), None, ts, {}, "job")
    runner.train_step(_image_samples(0))
    previous = signal.getsignal(signal.SIGTERM)
    try:
        runner.install_preemption_handler()
        if signal.getsignal(signal.SIGTERM) is previous:
            pytest.skip("not on the main thread: no handler could be installed")
        with pytest.raises(SystemExit) as exit_info:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):            # the handler runs between bytecodes
                pass
        assert exit_info.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, previous)
    state = torch.load(tmp_path / "checkpoint_-1.pt", weights_only=True)
    assert state["step"] == 1 and state["epoch"] == -1


def test_pad_to_bucket_equals_the_reference():
    from spider_tpu.runners.runner import _pad_to_bucket as jpad

    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    js = jF.build_tiny_spider(with_pipes=False)
    samples = _image_samples(0)
    a = pad_to_bucket(ts.prepare_batch(samples), 32, 0)
    b = jpad(js.prepare_batch(samples), 32, 0)
    assert a.input_ids.shape[1] % 32 == 0
    for f in ("input_ids", "targets", "signal_pos"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for m in a.slot_mask:
        np.testing.assert_array_equal(a.slot_mask[m], b.slot_mask[m])
        np.testing.assert_array_equal(a.slot_index[m], b.slot_index[m])


# ---------------------------------------------------------------------------
# the copied, framework-free modules equal their originals
# ---------------------------------------------------------------------------

def _assert_samples_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


BUILDERS = {
    "t2i_cc_sbu": dict(image_size=28, synthetic_size=32),
    "i2t_cc_sbu": dict(image_size=28, synthetic_size=32),
    "t2a_audiocap": dict(num_mels=16, target_length=20),
    "t2v_webvid": dict(image_size=28, synthetic_size=16, num_clips=2),
    "a2t_audiocap": dict(num_mels=16, target_length=20),
    "t2i_ts_cc_sbu": dict(image_size=28, synthetic_size=32),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_dataset_copies_give_the_same_samples(name):
    import spider_tpu.datasets  # noqa: F401  (registers the builders)
    import spider_tpu_torch.datasets  # noqa: F401
    from spider_tpu.common.registry import registry as jreg
    from spider_tpu_torch.common.registry import registry as treg

    cfg = dict(build_info=dict(BUILDERS[name], seed=3))
    jds = jreg.get_builder_class(name)(cfg).build_datasets()
    tds = treg.get_builder_class(name)(cfg).build_datasets()
    jit, tit = iter(jds), iter(tds)
    for _ in range(3):
        _assert_samples_equal(next(tit), next(jit))


def test_processor_copies_equal_their_originals():
    from spider_tpu.processors import audio as ja, text as jt, video as jv, vision as jvi
    from spider_tpu_torch.processors import audio as ta, text as tt, video as tv, vision as tvi

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    frames = rng.integers(0, 256, size=(9, 20, 31, 3), dtype=np.uint8)
    wav = rng.standard_normal(16000).astype(np.float32)
    s = 'A  "Dog"; runs: fast!! ' + "word " * 60
    assert tt.text_processor(s) == jt.text_processor(s)
    np.testing.assert_array_equal(tvi.image_to_imagebind(img, size=28),
                                  jvi.image_to_imagebind(img, size=28))
    np.testing.assert_array_equal(tvi.clip_image_transform(img, size=24),
                                  jvi.clip_image_transform(img, size=24))
    np.testing.assert_array_equal(tvi.sam_preprocess(img, size=64)[0],
                                  jvi.sam_preprocess(img, size=64)[0])
    np.testing.assert_array_equal(tv.video_to_clips(frames, num_clips=3, size=28),
                                  jv.video_to_clips(frames, num_clips=3, size=28))
    np.testing.assert_array_equal(ta.audio_to_clips(wav, num_mels=16, target_length=20),
                                  ja.audio_to_clips(wav, num_mels=16, target_length=20))


def test_loader_copies_equal_their_originals():
    from spider_tpu.datasets.utils import loaders as jl
    from spider_tpu_torch.datasets.utils import loaders as tl

    def sources():
        return [({"src": [i], "n": k, "x": np.full((2,), k)} for k in range(50))
                for i in range(3)]

    a = tl.MultiIterLoader([tl.batched(s, 2) for s in sources()], [2.0, 1.0, 1.0], seed=7)
    b = jl.MultiIterLoader([jl.batched(s, 2) for s in sources()], [2.0, 1.0, 1.0], seed=7)
    for _ in range(12):
        x, y = next(a), next(b)
        assert x["src"] == y["src"] and x["n"] == y["n"]
        for u, v in zip(x["x"], y["x"]):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError):
        tl.MultiIterLoader([])


def test_extend_tokenizer_copy_equals_its_original():
    assert tT.DEFAULT_MODALITY_TOKENS == jT.DEFAULT_MODALITY_TOKENS
    assert tT.DEFAULT_SPECIAL_TOKENS == jT.DEFAULT_SPECIAL_TOKENS
    for kw in (dict(), dict(new_modality_tokens={"IMAGE": 2, "BOX": 1}, bbox_bins=4,
                            new_special_tokens=["[INPUT]", "[END]"])):
        jtok, ttok = jT.TinyTokenizer(), tT.TinyTokenizer()
        assert tT.extend_tokenizer(ttok, **kw) == jT.extend_tokenizer(jtok, **kw)
        assert len(ttok) == len(jtok)
        s = "[INPUT]<IMAGE>a dog[IMAGE0][IMAGE1]</IMAGE><Loc3>[END] plain"
        assert ttok(s, add_special_tokens=False).input_ids == \
            jtok(s, add_special_tokens=False).input_ids
