"""spider_tpu_torch/parallel/{partition,moe,pipeline}.py against the JAX package.

Specs: every tensor of the tiny Llama (fp, int8 and with experts) and every
trainable tensor of the tiny Spider gets, validated against a mesh of
fsdp 2 x model 2 x expert 2, the spec JAX's ``tree_partition_specs`` gives
its leaf, carried onto the port's dims. Which port dim holds which JAX dim
is read off the converter itself: a JAX tree whose every leaf counts along
one dim is loaded (``load_jax_params`` / ``load_jax_spider``), and the port
dim along which the loaded tensor counts is that dim.

A 4-rank gloo world (tests/torch_dist_ranks.py::partition_world) then puts
the tiny Llamas on a mesh by ``shard_params`` (the placements of those
specs; the gathered tensors bit-equal), greedy-decodes through the
tensor-parallel Llama (the JAX model's tokens), runs
``moe_ffn_expert_parallel`` with 8 experts over 4 ranks (against
``moe_ffn_local`` on each rank's tokens, against the JAX EP function, and
its gradients against jax.grad of what that function computes) and
``gpipe`` over 4 stages (against the sequential stages and JAX's gpipe, its
gradients against jax.grad of the sequential stages).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.common import dist as jdist
from spider_tpu.models import factory as jF
from spider_tpu.models import llama as jL
from spider_tpu.parallel import moe as jmoe
from spider_tpu.parallel import partition as jP
from spider_tpu.parallel.pipeline import gpipe as jgpipe
from spider_tpu_torch.common.dist import AXES
from spider_tpu_torch.models import factory as tF
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params, load_jax_spider
from spider_tpu_torch.parallel import moe as tmoe
from spider_tpu_torch.parallel import partition as P
from torch_dist_ranks import placement_key, run_world

SIZES = dict(data=1, fsdp=2, model=2, expert=2, context=1)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype=np.asarray(x).dtype), tree)


def _llama_tree(quantization=None, experts=0, seed=0, lora_r=0):
    cfg = dataclasses.replace(jL.llama_tiny(vocab_size=64, lora_r=lora_r),
                              quantization=quantization, num_experts=experts,
                              intermediate_size=32 if experts else 128)
    m = jL.LlamaForCausalLM(cfg)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(s):
        if s.dtype == jnp.int8:
            return rng.integers(-100, 100, s.shape).astype(np.int8)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return m, jax.tree_util.tree_map(fill, shapes)


def _port_llama(quantization=None, experts=0):
    cfg = dataclasses.replace(tL.llama_tiny(vocab_size=64), quantization=quantization,
                              num_experts=experts, intermediate_size=32 if experts else 128)
    return tL.LlamaForCausalLM(cfg)


def _tagged(tree, d):
    """Each leaf counting along its dim d (zeros where it has none)."""
    def tag(x):
        x = np.asarray(x)
        if x.ndim <= d:
            return np.zeros_like(x)
        shape = [1] * x.ndim
        shape[d] = x.shape[d]
        return np.broadcast_to((np.arange(x.shape[d]) % 100).reshape(shape),
                               x.shape).astype(x.dtype)
    return jax.tree_util.tree_map(tag, tree)


def _jax_dims(module, tree, load, names):
    """{port name: [the JAX dim each port dim holds, or None]}."""
    maxd = max(np.ndim(x) for x in jax.tree_util.tree_leaves(tree))
    dims = {n: [None] * module.state_dict()[n].dim() for n in names}
    for d in range(maxd):
        load(module, _tagged(tree, d))
        state = module.state_dict()
        for n in names:
            t = state[n].float()
            for k in range(t.dim()):
                if t.shape[k] > 1 and not torch.equal(t.narrow(k, 0, 1).expand_as(t), t):
                    dims[n][k] = d
    return dims


def _jax_leaf_specs(tree, rules):
    """{JAX path: spec validated against SIZES}."""
    mesh = types.SimpleNamespace(shape=SIZES)
    specs = jP.tree_partition_specs(tree, rules)
    flat = jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    leaves = dict((jP.path_str(p), np.shape(x)) for p, x in
                  jax.tree_util.tree_leaves_with_path(tree))
    return {jP.path_str(p): tuple(jP._validate_spec(s, leaves[jP.path_str(p)], mesh))
            for p, s in flat}


def _fake_mesh():
    return types.SimpleNamespace(mesh_dim_names=AXES,
                                 mesh=np.zeros([SIZES[a] for a in AXES]))


def _expected(module, tree, load, names, rules, to_jax_path):
    jspecs = _jax_leaf_specs(tree, rules)
    dims = _jax_dims(module, tree, load, names)
    out = {}
    for n in names:
        spec = jspecs[to_jax_path(n)]       # one entry per dim of the JAX leaf
        out[n] = tuple(spec[d] if d is not None else None for d in dims[n])
    return out


def _port_jax_path(module, prefix=""):
    def f(name):
        path = P.rule_path(module, name)
        path = "/".join(p for p in path.split("/") if not p.isdigit())
        return prefix + path
    return f


LLAMAS = {"fp": (None, 0), "int8": ("int8", 0), "moe": (None, 4)}


@pytest.mark.parametrize("kind", list(LLAMAS))
def test_every_llama_tensor_gets_the_jax_spec(kind):
    quant, experts = LLAMAS[kind]
    _, tree = _llama_tree(quant, experts)
    port = _port_llama(quant, experts)
    names = P.tensor_names(port)
    want = _expected(port, tree, load_jax_params, names, jP.LLAMA_RULES,
                     _port_jax_path(port, "params/"))
    mesh = _fake_mesh()
    state = port.state_dict()
    got = {n: P._validate_spec(s, state[n].shape, mesh)
           for n, s in P.tree_partition_specs(port).items()}
    assert got == want
    if kind == "moe":
        assert got["model.layers.0.mlp.w1"] == ("expert", "fsdp", "model")
    if kind == "int8":
        assert got["model.layers.0.self_attn.q_proj.kernel_q"] == ("model", "fsdp")
        assert got["lm_head.kernel_scale"] == ("model",)


def test_every_trainable_spider_tensor_gets_the_jax_spec():
    js = jF.build_tiny_spider(with_pipes=False)
    tree = _np_tree(js.trainable_params())
    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    names = list(ts.trainable_params())

    def to_jax(name):
        path = _port_jax_path(ts)(name)
        head, _, rest = path.partition("/")
        if head == "llm":
            return f"llm/params/{rest}"
        if head in ("aligners",):
            mod, _, rest = rest.partition("/")
            return f"aligners/{mod}/params/{rest}"
        if head == "moe_aligner":
            return f"moe_aligner/params/{rest}"
        return path

    want = _expected(ts, tree, lambda m, t: load_jax_spider(m, t), names, jP.SPIDER_RULES,
                     to_jax)
    mesh = _fake_mesh()
    state = ts.state_dict()
    got = {n: P._validate_spec(P.param_spec(ts, n, P.SPIDER_RULES), state[n].shape, mesh)
           for n in names}
    assert got == want
    assert got["llama_proj.weight"] == ("fsdp", None)
    assert got["llm.model.layers.0.self_attn.q_proj.lora_b"] == (None, "model")


def test_trainable_mask_equals_the_jax_mask():
    _, tree = _llama_tree(lora_r=2)
    port = load_jax_params(tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=64, lora_r=2)), tree)
    mask = P.trainable_mask(port, (r"lora_",))
    jmask = jP.trainable_mask(tree, (r"lora_",))
    flat = {jP.path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(jmask)}
    to_jax = _port_jax_path(port, "params/")
    assert {n: flat[to_jax(n)] for n in mask} == mask
    assert any(mask.values()) and not all(mask.values())


@pytest.mark.parametrize("row0", [0, 2, 4])
def test_freeze_embedding_rows_masks_by_the_global_row(row0):
    """The port's mask on a shard starting at global row row0, against the
    optax transform on the whole matrices (embedding [V, H]; the port's
    lm_head [V, H] against flax's [H, V])."""
    tx = jP.freeze_embedding_rows(3)
    updates = {"embed_tokens": {"embedding": jnp.ones((6, 4))},
               "lm_head": {"kernel": jnp.ones((4, 6))}}
    want, _ = tx.update(updates, tx.init(updates))
    for name, w in (("embed_tokens.weight", want["embed_tokens"]["embedding"]),
                    ("lm_head.weight", want["lm_head"]["kernel"].T)):
        assert P.frozen_row_names([name], 3) == [name]
        u = torch.ones(2, 4)
        P.freeze_embedding_rows(u, 3, row0)
        np.testing.assert_array_equal(u.numpy(), np.asarray(w)[row0:row0 + 2])


def test_tensor_parallel_plan_is_read_from_the_rules():
    plan = P.tensor_parallel_plan(_port_llama())
    assert plan["embed_tokens"] == "vocab" and plan["lm_head"] == "colwise"
    for i in range(2):
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "mlp.gate_proj", "mlp.up_proj"):
            assert plan[f"model.layers.{i}.{proj}"] == "colwise"
        for proj in ("self_attn.o_proj", "mlp.down_proj"):
            assert plan[f"model.layers.{i}.{proj}"] == "rowwise"
    assert len(plan) == 2 + 2 * 7


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------

E, M, FF, TOK = 8, 8, 16, 8       # experts, width, hidden, tokens per rank
S, MB = 4, 6                      # pipeline stages, microbatches
SHARD_MESH = dict(data=1, fsdp=2, model=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(11)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    _, fp = _llama_tree()
    _, q8 = _llama_tree("int8")
    ids = rng.integers(0, 64, (1, 8))
    ep = dict(wg=f(M, E), w1=f(E, M, FF, scale=0.3), w2=f(E, FF, M, scale=0.3),
              x=f(4 * TOK, M), g=f(4 * TOK, M),
              cfg_kw=dict(num_experts=E, d_model=M, d_ff=FF, capacity_factor=2.0))
    pipe = dict(ws=f(S, M, M, scale=0.3), bs=f(S, M, scale=0.1), x=f(MB, 3, M), g=f(MB, 3, M))
    res = run_world("partition_world", 4, tmp_path_factory.mktemp("partition"),
                    shard=dict(params=fp, params_int8=q8, mesh_kw=SHARD_MESH),
                    tp=dict(params=fp, ids=ids, new_tokens=6), ep=ep, pipe=pipe)
    return dict(res=res, fp=fp, q8=q8, ids=ids, ep=ep, pipe=pipe)


@pytest.mark.parametrize("i,quant", [(0, None), (1, "int8")])
def test_shard_params_places_every_tensor_by_its_spec(world, i, quant):
    port = _port_llama(quant)
    mesh = types.SimpleNamespace(mesh_dim_names=AXES, mesh=np.zeros(
        [dict(SIZES, **SHARD_MESH, expert=1)[a] for a in AXES]))
    state = port.state_dict()
    want = {n: placement_key(P.placements(P._validate_spec(s, state[n].shape, mesh), mesh))
            for n, s in P.tree_partition_specs(port).items()}
    for res in world["res"]:
        assert res["shard"][i]["placements"] == want
        assert res["shard"][i]["same"]
    assert want["model.layers.0.self_attn.q_proj." + ("kernel_q" if quant else "weight")] == \
        [("Replicate", None), ("Shard", 1), ("Shard", 0), ("Replicate", None),
         ("Replicate", None)]


def test_tensor_parallel_greedy_generate_gives_the_jax_tokens(world):
    from spider_tpu.models.decode import GenerateConfig, generate

    m = jL.LlamaForCausalLM(jL.llama_tiny(vocab_size=64))
    params = jax.tree_util.tree_map(jnp.asarray, world["fp"])
    ids = jnp.asarray(world["ids"])
    emb = m.apply(params, ids, method=m.embed)
    want = generate(m, params, emb, jnp.array([ids.shape[1]], jnp.int32),
                    GenerateConfig(max_new_tokens=6))["tokens"]
    for res in world["res"]:
        np.testing.assert_array_equal(res["tp"]["tokens"], np.asarray(want))
        assert res["tp"]["plan"] == P.tensor_parallel_plan(_port_llama())


def _jax_ep(ep):
    """The JAX EP function's forward over an expert axis of 4, and the
    gradients of the same loss through JAX's moe_ffn_local on each rank's
    tokens, which is what the EP function computes: jax.grad through the
    EP function itself fails in its all_to_all's transpose (ROADMAP C21)."""
    cfg = jmoe.MoEConfig(**ep["cfg_kw"])
    mesh = jdist.make_mesh(data=1, expert=4, devices=jax.devices()[:4])
    args = [jnp.asarray(ep[k]) for k in ("x", "wg", "w1", "w2")]
    out, aux = jmoe.moe_ffn_expert_parallel(dict(wg=args[1], w1=args[2], w2=args[3]), args[0],
                                            cfg, mesh)

    def loss(x, wg, w1, w2):
        total, auxes = 0.0, []
        for r in range(4):
            o, a = jmoe.moe_ffn_local(dict(wg=wg, w1=w1, w2=w2), x[r * TOK:(r + 1) * TOK], cfg)
            total = total + jnp.sum(o * ep["g"][r * TOK:(r + 1) * TOK])
            auxes.append(a)
        return total + sum(auxes) / 4

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args), (out, aux)


def test_expert_parallel_equals_moe_ffn_local_on_each_ranks_tokens(world):
    ep = world["ep"]
    cfg = tmoe.MoEConfig(**ep["cfg_kw"])
    params = {k: torch.from_numpy(ep[k]) for k in ("wg", "w1", "w2")}
    for r, res in enumerate(world["res"]):
        out, aux = tmoe.moe_ffn_local(params, torch.from_numpy(ep["x"][r * TOK:(r + 1) * TOK]),
                                      cfg)
        torch.testing.assert_close(res["ep"]["out"], out, rtol=1e-5, atol=1e-5)
    auxes = [tmoe.moe_ffn_local(params, torch.from_numpy(ep["x"][r * TOK:(r + 1) * TOK]),
                                cfg)[1] for r in range(4)]
    assert world["res"][0]["ep"]["aux"] == pytest.approx(float(sum(auxes) / 4), rel=1e-6)


def test_expert_parallel_and_its_gradients_match_the_jax_ones(world):
    ep = world["ep"]
    (dx, dwg, dw1, dw2), (out, aux) = _jax_ep(ep)
    res = [r["ep"] for r in world["res"]]
    close = lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4)
    close(torch.cat([r["out"] for r in res]).numpy(), out)
    assert res[0]["aux"] == pytest.approx(float(aux), rel=1e-5)
    close(torch.cat([r["dx"] for r in res]).numpy(), dx)
    close(sum(r["dwg"] for r in res).numpy(), dwg)          # wg is replicated
    close(torch.cat([r["dw1"] for r in res]).numpy(), dw1)  # rank r holds experts 2r, 2r + 1
    close(torch.cat([r["dw2"] for r in res]).numpy(), dw2)


def test_gpipe_matches_the_sequential_stages_and_jax_gpipe(world):
    pipe = world["pipe"]
    mesh = jdist.make_mesh(data=1, model=S, devices=jax.devices()[:S])
    stage = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])

    def loss(params):           # the stages one after another
        h = jnp.asarray(pipe["x"])
        for s in range(S):
            h = stage(dict(w=params["w"][s], b=params["b"][s]), h)
        return jnp.sum(h * pipe["g"])

    params = dict(w=jnp.asarray(pipe["ws"]), b=jnp.asarray(pipe["bs"]))
    want = jgpipe(stage, params, jnp.asarray(pipe["x"]), mesh, axis="model")
    grads = jax.jit(jax.grad(loss))(params)
    seq = pipe["x"]
    for s in range(S):
        seq = np.tanh(seq @ pipe["ws"][s] + pipe["bs"][s])
    for s, res in enumerate(world["res"]):
        np.testing.assert_allclose(res["pipe"]["out"].numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["pipe"]["out"].numpy(), seq, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["pipe"]["dw"].numpy(), np.asarray(grads["w"][s]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["pipe"]["db"].numpy(), np.asarray(grads["b"][s]),
                                   rtol=1e-4, atol=1e-5)


def test_gpipe_of_one_stage_is_the_stage_function():
    from spider_tpu_torch.parallel.pipeline import gpipe

    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((M, M)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((MB, 3, M)).astype(np.float32))
    fn = lambda p, h: torch.tanh(h @ p)
    assert torch.equal(gpipe(fn, w, x, None), torch.stack([fn(w, x[i]) for i in range(MB)]))
