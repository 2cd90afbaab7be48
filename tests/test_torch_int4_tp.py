"""Tensor parallelism of int4 projections (spider_tpu_torch/parallel/partition.py
``parallelize_llama`` through ``_shard_int4``) against the one-process int4
Llama and the JAX package.

A 2-rank gloo world (tests/torch_dist_ranks.py::tp_generate_int4) makes the
tiny int4 Llama tensor-parallel over model 2 and decodes greedily on the
CPU plain path; its tokens must be the one-process int4 model's and the JAX
int4 model's, as tests/test_torch_partition.py holds the fp Llama's. A
row-wise shard keeps its contiguous input columns, repacked: the test also
holds the repacked kernel's product to the whole kernel's on a slice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import llama as jL
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.decode import GenerateConfig, generate
from spider_tpu_torch.ops import quant as tQ
from test_torch_partition import _llama_tree
from torch_dist_ranks import run_world

NEW_TOKENS = 6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, tree = _llama_tree("int4", seed=3)
    ids = np.random.default_rng(12).integers(0, 64, (1, 8))
    res = run_world("tp_generate_int4", 2, tmp_path_factory.mktemp("int4_tp"), params=tree,
                    ids=ids, new_tokens=NEW_TOKENS)
    return dict(res=res, tree=tree, ids=ids)


def test_int4_tensor_parallel_greedy_tokens_equal_the_one_process_model(world):
    cfg = dataclasses.replace(tL.llama_tiny(vocab_size=64), quantization="int4")
    model = load_jax_params(tL.LlamaForCausalLM(cfg), world["tree"])
    ids = torch.from_numpy(world["ids"])
    with torch.no_grad():
        want = generate(model, model.embed(ids), torch.tensor([ids.shape[1]], dtype=torch.int32),
                        GenerateConfig(max_new_tokens=NEW_TOKENS))["tokens"].numpy()
    for res in world["res"]:
        np.testing.assert_array_equal(res["tokens"], want)
        # q_proj [64, 32] packed keeps half its output rows; o_proj half its columns
        assert res["q_q"] == (32, 32) and res["o_q"] == (64, 16)


def test_int4_tensor_parallel_greedy_tokens_equal_the_jax_model(world):
    from spider_tpu.models.decode import GenerateConfig as JGenerateConfig
    from spider_tpu.models.decode import generate as jgenerate

    m = jL.LlamaForCausalLM(dataclasses.replace(jL.llama_tiny(vocab_size=64),
                                                quantization="int4"))
    params = jax.tree_util.tree_map(jnp.asarray, world["tree"])
    ids = jnp.asarray(world["ids"])
    emb = m.apply(params, ids, method=m.embed)
    want = jgenerate(m, params, emb, jnp.array([ids.shape[1]], jnp.int32),
                     JGenerateConfig(max_new_tokens=NEW_TOKENS))["tokens"]
    for res in world["res"]:
        np.testing.assert_array_equal(res["tokens"], np.asarray(want))


@pytest.mark.parametrize("n", [2, 4])
def test_repacked_row_shards_sum_to_the_whole_product(n):
    """Each rank's repacked kernel times its contiguous columns of x sums,
    over the ranks, to the whole int4 product (the arithmetic _shard_int4's
    row-wise hook completes with an all-reduce)."""
    rng = np.random.default_rng(n)
    packed = torch.from_numpy(rng.integers(-128, 128, (24, 32)).astype(np.int8))   # [out, in/2]
    scale = torch.from_numpy(rng.random(24).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    cols = tQ.unpack_int4(packed.t(), torch.int8)
    k = 64 // n
    parts = [tQ.int4_matmul(x[:, r * k:(r + 1) * k],
                            tQ.pack_int4(cols[r * k:(r + 1) * k]).t().contiguous(), scale,
                            out_dtype=torch.float32) for r in range(n)]
    torch.testing.assert_close(sum(parts), tQ.int4_matmul(x, packed, scale,
                                                          out_dtype=torch.float32),
                               atol=1e-4, rtol=0)
