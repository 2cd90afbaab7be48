"""The repo's train configs through the port on the CPU.

Every ``train_configs/*.py`` loads in the port: training recipes go through
``setup_task -> build_datasets`` (the datasets' first samples equal the JAX
package's), decoder configs build the port's ``SpiderDecoder`` with the JAX
package's system prompt.

The slice: ``train_configs/spider_train.py`` at its own tiny preset (with the
tiny SAM) through the port's ``build_runner``: all 21 builders, the runner,
and one ``train_step`` each on a batch of ``it2m_refcoco`` (MASK through
SAM), ``it2b_ts_refcoco`` and ``pororo``, whose losses equal what the JAX
runner's ``train_step`` computes on the same batch and weights within 1e-4
(fp32): its preparation and its jitted loss, without the gradient and
optimizer, whose compile would cost minutes here.
The grounding and story builders give ImageBind a 224 px image whatever
``image_size`` says, which the tiny ImageBind (28 px) cannot take in either
package; both Spiders get the same tiny ImageBind at 224 px instead.
"""

import glob
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "train_configs", "*.py")))
SLICE_CFG = os.path.join(ROOT, "train_configs", "spider_train.py")
SLICE_BUILDERS = ("it2m_refcoco", "it2b_ts_refcoco", "pororo")


def _jax_config(path):
    from spider_tpu.common.config import Config

    return Config.fromfile(path)


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)[:-3] for p in CONFIGS])
def test_config_goes_through_the_ports_task_and_builders(path):
    from spider_tpu import register_all as jregister_all
    from spider_tpu import tasks as jtasks
    from spider_tpu_torch import tasks as ttasks
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.registry import registry
    from spider_tpu_torch.train import register_all
    from test_torch_datasets import assert_same

    register_all()
    if os.path.basename(path) == "decoder_prompt_variants.py":
        spec = importlib.util.spec_from_file_location("variants", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert len(mod.VARIANTS) == 12
        return
    cfg = Config.fromfile(path)
    assert registry.get_model_class(cfg.model.type) is not None or \
        cfg.model.type == "spider_decoder"
    if cfg.model.type == "spider_decoder":
        from spider_tpu.common.registry import registry as jreg
        from spider_tpu_torch.models import spider_decoder  # noqa: F401  (registers it)

        jregister_all()
        kw = dict(cfg.model)
        dec = registry.get_model_class(kw.pop("type"))(**kw)
        jkw = dict(_jax_config(path).model)
        jdec = jreg.get_model_class(jkw.pop("type"))(**jkw)
        assert dec.system_prompt and dec.system_prompt == jdec.system_prompt
        return
    task = ttasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    jregister_all()
    jcfg = _jax_config(path)
    jdatasets = jtasks.setup_task(jcfg).build_datasets(jcfg)
    assert {s: list(d) for s, d in datasets.items()} == \
        {s: list(d) for s, d in jdatasets.items()}
    for split, entries in datasets.items():
        for name, entry in entries.items():
            want = jdatasets[split][name]
            assert (entry["batch_size"], entry["sample_ratio"]) == \
                (want["batch_size"], want["sample_ratio"])
            assert_same(next(iter(entry["dataset"])), next(iter(want["dataset"])), name)


# ---------------------------------------------------------------------------
# the slice: spider_train.py's tiny preset, the port's runner vs the JAX one
# ---------------------------------------------------------------------------

def _imagebind_224():
    """Both packages' tiny ImageBind config at 224 px."""
    import dataclasses

    from spider_tpu.models import imagebind as jIB
    from spider_tpu_torch.models import imagebind as tIB

    return (dataclasses.replace(jIB.imagebind_tiny(), image_size=224),
            dataclasses.replace(tIB.imagebind_tiny(), image_size=224))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port runner, JAX Spider) over spider_train.py's tiny preset with the
    tiny SAM, on the same weights. The config's pipelines are left out: the
    slice's three tasks take no decoder conditioning."""
    from spider_tpu.models import factory as jF
    from spider_tpu.models import imagebind as jIB
    from spider_tpu_torch import train as ttrain
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models import imagebind as tIB
    from spider_tpu_torch.models.convert import load_jax_spider
    from test_torch_spider_model import _numpy_tree

    cfg = Config.fromfile(SLICE_CFG)
    cfg.model.with_sam = True
    cfg.model.with_pipes = False
    cfg.run.output_dir = str(tmp_path_factory.mktemp("slice"))
    runner = ttrain.build_runner(cfg, torch.device("cpu"), "slice")

    model = dict(cfg.model)
    js = jF.build_tiny_spider(with_pipes=False, with_sam=True, lora_r=model["lora_r"],
                              max_context_len=model["max_context_len"])
    jcfg_ib, tcfg_ib = _imagebind_224()
    js.encoder = jIB.ImageBindEncoder(jcfg_ib)
    js.encoder_params = jF.random_params_like(
        js.encoder, jax.random.PRNGKey(1),
        {"vision": jnp.zeros((1, 3, 2, 224, 224)),
         "audio": jnp.zeros((1, 1, jcfg_ib.audio_mel_bins, jcfg_ib.audio_target_len))})
    ts = runner.model
    ts.encoder = tIB.ImageBindEncoder(tcfg_ib, ts.device).requires_grad_(False).eval()
    load_jax_spider(ts, _numpy_tree(js.trainable_params()), _numpy_tree(js.encoder_params))
    return runner, js


def _jax_runner_loss(js, samples, bucket, params):
    """The loss dict spider_tpu/runners/runner.py::RunnerBase.train_step
    computes for `samples` at `params` (its step's loss_fn before the
    update), without the gradient and the optimizer."""
    import dataclasses

    from spider_tpu.models.spider import PreparedBatch
    from spider_tpu.runners.runner import _pad_to_bucket

    task = samples["TaskPrompt"][0][1:-1]
    batch = _pad_to_bucket(js.prepare_batch(samples), bucket, js.tokenizer.pad_token_id)
    modality_embeds = js.encode_modalities(batch)
    aux = None
    if task == "MASK" and js.sam is not None and "IMAGE_SAM" in samples:
        aux = {"IMAGE_SAM": np.stack([np.asarray(x) for x in samples["IMAGE_SAM"]]),
               "MASK_GT": np.stack([np.asarray(x) for x in samples["MASK"]])}
    elif task == "MASK":
        task = "TEXT"
    loss = jax.jit(lambda p, b, e, a: js.compute_loss(p, PreparedBatch(**b), e, None, task, a))
    return loss(params, dataclasses.asdict(batch), modality_embeds, aux)


def _merged(base, new):
    """`base` (a JAX tree) with every leaf that `new` holds replaced by
    new's: the port exports SAM's trainable mask decoder, the JAX loss takes
    all of SAM."""
    if not isinstance(base, dict):
        return jnp.asarray(new)
    return {k: _merged(v, new[k]) if k in new else v for k, v in base.items()}


def test_slice_runner_holds_all_21_builders_and_the_config(pair):
    from test_torch_datasets import ALL_BUILDERS

    runner, _ = pair
    assert sorted(runner.datasets["train"]) == sorted(ALL_BUILDERS)
    spider = runner.model
    assert spider.sam is not None and spider.max_context_len == 500
    assert spider.llm.config.lora.r == 32 and runner.length_bucket == 64
    ratios = {n: e["sample_ratio"] for n, e in runner.datasets["train"].items()}
    assert ratios["t2i_cc_sbu"] == 2.0 and ratios["it2m_ts_refcoco"] == 0.5


def test_slice_train_steps_equal_the_jax_runners(pair):
    """Each port train_step's losses against the JAX runner's on the same
    batch and weights: the port's weights as they stand before that step."""
    from spider_tpu_torch.datasets.utils.loaders import batched
    from spider_tpu_torch.models.convert import spider_trainable_to_jax

    runner, js = pair
    tasks = []
    for name in SLICE_BUILDERS:
        entry = runner.datasets["train"][name]
        batch = next(batched(iter(entry["dataset"]), entry["batch_size"]))
        tasks.append(batch["TaskPrompt"][0])
        params = _merged(js.trainable_params(), spider_trainable_to_jax(runner.model))
        jout = _jax_runner_loss(js, batch, runner.length_bucket, params)
        tout = runner.train_step(batch)
        assert set(tout) == set(jout), name
        for k in jout:
            assert np.isfinite(tout[k]), (name, k)
            assert tout[k] == pytest.approx(float(jout[k]), rel=1e-4, abs=1e-4), (name, k)
        if name == "it2m_refcoco":
            assert {"bce_loss", "dice_loss"} <= set(tout)
    assert tasks == ["[MASK]", "[SMARTMULTIMODAL]", "[STORY]"]
    assert runner.global_step == 3
