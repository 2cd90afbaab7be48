"""Checkpoint loading on the card: the int8 quantisation of
``convert.quantize_int8`` on the device against the CPU and against the
reference's numpy formula (spider_tpu/models/convert.py:69-75), bit for bit,
and a streamed load that leaves nothing on the CPU.

These tests need an NVIDIA GPU and skip without one. They import torch and
numpy only, so they also run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_convert_cuda.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from spider_tpu_torch.models import checkpoint_io as io
from spider_tpu_torch.models import convert as C
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import llama as L

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _numpy_int8(w: np.ndarray):
    """The reference's rule on one [out, in] matrix, in its [in, out] layout."""
    arr = w.T
    scale = np.max(np.abs(arr), axis=-2, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-8)
    q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
    return q.T, scale.squeeze(-2)


def _edge_rows():
    """An all-zero row (scale 1e-8), rows whose w / scale fall on exact
    halves (round half to even), a row of one sign, tiny and huge values."""
    rows = np.zeros((6, 16), np.float32)
    rows[1, :9] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    rows[2, :4] = [-254.0, 1.0, 3.0, -5.0]             # scale 2: halves again
    rows[3] = np.linspace(0.1, 3.0, 16)
    rows[4, :3] = [1e-30, -2e-30, 5e-31]
    rows[5, :3] = [3e38, -1e38, 1.0]
    return rows


@pytest.mark.parametrize("case", ["llama3_8b_down", "edge_rows"])
def test_int8_quantisation_on_device_is_the_cpus_and_numpys(dev, case):
    if case == "edge_rows":
        w = torch.from_numpy(_edge_rows())
    else:
        g = torch.Generator().manual_seed(0)
        w = (0.02 * torch.randn(14336, 4096, generator=g)).to(torch.bfloat16)
    q_cpu, s_cpu = C.quantize_int8(w)
    q_dev, s_dev = C.quantize_int8(w.to(dev))
    assert q_dev.device.type == "cuda" and q_dev.dtype == torch.int8
    assert s_dev.dtype == torch.float32
    assert torch.equal(q_dev.cpu(), q_cpu) and torch.equal(s_dev.cpu(), s_cpu)
    q_np, s_np = _numpy_int8(w.float().numpy())
    np.testing.assert_array_equal(q_cpu.numpy(), q_np)
    np.testing.assert_array_equal(s_cpu.numpy(), s_np)
    if case == "edge_rows":
        assert s_cpu[0].item() == np.float32(1e-8) and not q_cpu[0].any()
        assert q_cpu[1, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]
        assert q_cpu[2, :4].tolist() == [-127, 0, 2, -2]


def _tiny_llama_dir(path):
    cfg = L.llama_tiny(vocab_size=300)
    g = torch.Generator().manual_seed(1)
    model = L.LlamaForCausalLM(cfg, "cpu")
    state = {n: torch.randn(t.shape, generator=g) * 0.02 for n, t in model.state_dict().items()}
    hf = C.export_state_dict(C.llama_rules({"lm_head.weight"}, cfg), state)
    hf = {k: v.to(torch.bfloat16) for k, v in hf.items()}
    keys = sorted(hf)
    io.save_sharded([{k: hf[k] for k in keys[:7]}, {k: hf[k] for k in keys[7:]}], path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(model_type="llama", vocab_size=300, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=512, rope_theta=10000.0), f)
    return hf


def test_streamed_load_leaves_nothing_on_the_cpu(dev, tmp_path):
    hf = _tiny_llama_dir(str(tmp_path))
    model, _ = factory.from_pretrained("llama", path=str(tmp_path), device=dev)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())             # non-persistent ones too
    assert tensors and all(t.device.type == "cuda" for t in tensors.values())
    cpu_model, _ = factory.from_pretrained("llama", path=str(tmp_path), device="cpu")
    for name, t in cpu_model.state_dict().items():
        assert torch.equal(model.state_dict()[name].cpu(), t), name
    q, s = C.quantize_int8(hf["model.layers.1.mlp.up_proj.weight"].to(dev))
    assert torch.equal(model.model.layers[1].mlp.up_proj.kernel_q, q)
    assert torch.equal(model.model.layers[1].mlp.up_proj.kernel_scale, s)
    _, fp = C.convert_llama_checkpoint(str(tmp_path), device=dev)
    assert all(t.device.type == "cuda" for t in fp.state_dict().values())
