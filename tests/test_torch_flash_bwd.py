"""The port's plain flash backward, ``flash_backward_reference``, against the
JAX package and against torch autograd, in fp32 on the CPU.

(a) Against the JAX package's ``_flash_backward``: the Pallas dq and dk/dv
kernels under ``pltpu.force_tpu_interpret_mode()``, as tests/test_ops.py runs
them on the CPU. The Pallas form needs D % 64 == 0 and block-divisible T and
S; the other cases take ``jax.vjp`` through the JAX ``mha_reference`` /
``mha_reference_with_lse``. Interpret cases are kept small: they are slow.
(b) Against torch autograd through the port's ``mha_reference`` and
``mha_reference_with_lse`` (with a non-zero lse cotangent).

Inputs are made with numpy from a seed. Every case keeps at least one live
key in every query row: on rows with none the kernels give zero gradient and
autograd through the plain attention does not. Tolerance 2e-4 for (a) under
interpret (its blockwise fp32 sums run in another order, and it takes the
lse of its own online-softmax forward), 2e-5 elsewhere: the same fp32
arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spider_tpu.ops import attention as jA
from spider_tpu_torch.ops import attention as tA


def _inputs(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, T, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, T, Hq, D)


def _torch_kw(kw):
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _port_backward(q, k, v, g, g_lse=None, **kw):
    """flash_backward_reference on the out and lse of the port's forward."""
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = _torch_kw(kw)
    out, lse = tA.mha_reference_with_lse(tq, tk, tv, **kw)
    tgl = None if g_lse is None else torch.from_numpy(g_lse)
    return tA.flash_backward_reference(tq, tk, tv, out, lse, tg, g_lse=tgl, **kw)


def _assert_grads(got, want, atol):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0,
                                   err_msg=name)


PALLAS_CASES = {
    "causal_gqa_4_2": ((1, 128, 128, 4, 2, 64), dict(causal=True), 64),
    "full_gqa_8_1": ((1, 64, 128, 8, 1, 64), dict(causal=False), 64),
    "kv_len_D128": ((2, 64, 128, 2, 2, 128),
                    dict(causal=True, kv_len=np.array([100, 128], np.int32)), 64),
    "q_offset": ((2, 64, 128, 4, 2, 64),
                 dict(causal=True, kv_len=np.array([90, 128], np.int32),
                      q_offset=np.array([20, 64], np.int32)), 32),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_reference_matches_the_pallas_backward_in_interpret_mode(case):
    shape, kw, block = PALLAS_CASES[case]
    q, k, v, g = _inputs(*shape, seed=1)
    D = shape[-1]
    jkw = _jax_kw(kw)
    with pltpu.force_tpu_interpret_mode():
        out, lse8 = jA._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jkw["causal"], D ** -0.5, jkw.get("kv_len"),
                                      jkw.get("q_offset"), block, block)
        want = jA._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse8,
                                  jnp.asarray(g), jkw["causal"], D ** -0.5,
                                  jkw.get("kv_len"), jkw.get("q_offset"), block, block)
    _assert_grads(_port_backward(q, k, v, g, **kw), want, 2e-4)
    # and on the Pallas forward's own out and lse
    got = tA.flash_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse8[..., 0])), torch.from_numpy(g), **_torch_kw(kw))
    _assert_grads(got, want, 2e-4)


def test_reference_matches_the_pallas_backward_with_lse_cotangent():
    q, k, v, g = _inputs(1, 64, 64, 4, 2, 64, seed=2)
    g_lse = np.random.default_rng(3).standard_normal((1, 4, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, lse8 = jA._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                                      0.125, None, None, 64, 64)
        want = jA._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse8,
                                  jnp.asarray(g), True, 0.125, None, None, 64, 64,
                                  g_lse=jnp.asarray(g_lse))
    _assert_grads(_port_backward(q, k, v, g, g_lse=g_lse, causal=True), want, 2e-4)


PLAIN_CASES = {
    "causal_D16": ((2, 9, 9, 4, 2, 16), dict(causal=True)),
    "full_D40_ragged": ((2, 7, 13, 8, 1, 40), dict(causal=False)),
    "suffix_T_lt_S": ((1, 5, 12, 4, 2, 16), dict(causal=True)),
    "kv_len_D40": ((2, 6, 11, 4, 2, 40),
                   dict(causal=True, kv_len=np.array([8, 11], np.int32))),
    "kv_len_full": ((2, 6, 11, 8, 1, 64),
                    dict(causal=False, kv_len=np.array([3, 11], np.int32))),
    "q_offset_D128": ((2, 5, 12, 4, 2, 128),
                      dict(causal=True, kv_len=np.array([9, 12], np.int32),
                           q_offset=np.array([2, 7], np.int32))),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_reference_matches_jax_vjp_of_the_plain_attention(case):
    shape, kw = PLAIN_CASES[case]
    q, k, v, g = _inputs(*shape, seed=4)
    g_lse = np.random.default_rng(5).standard_normal(
        (shape[0], shape[3], shape[1])).astype(np.float32)
    jkw = _jax_kw(kw)
    _, vjp = jax.vjp(lambda a, b, c: jA.mha_reference(a, b, c, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _assert_grads(_port_backward(q, k, v, g, **kw), vjp(jnp.asarray(g)), 2e-5)
    _, vjp = jax.vjp(lambda a, b, c: jA.mha_reference_with_lse(a, b, c, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _assert_grads(_port_backward(q, k, v, g, g_lse=g_lse, **kw),
                  vjp((jnp.asarray(g), jnp.asarray(g_lse))), 2e-5)


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
@pytest.mark.parametrize("with_lse", [False, True])
def test_reference_matches_torch_autograd(case, with_lse):
    shape, kw = PLAIN_CASES[case]
    q, k, v, g = _inputs(*shape, seed=6)
    g_lse = np.random.default_rng(7).standard_normal(
        (shape[0], shape[3], shape[1])).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tkw = _torch_kw(kw)
    if with_lse:
        # through the public entry: on CPU tensors it is the plain version
        out, lse = tA.flash_attention_with_lse(*leaves, **tkw)
        ((out * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum()).backward()
    else:
        (tA.flash_attention(*leaves, **tkw) * torch.from_numpy(g)).sum().backward()
    got = _port_backward(q, k, v, g, g_lse=g_lse if with_lse else None, **kw)
    _assert_grads([x.detach() for x in got], [x.grad for x in leaves], 2e-5)


def test_rows_without_a_live_key_get_zero_gradient():
    # kv_len 0 for sample 1: the reference's where(mask, ..., 0) zeroes P
    # there, whatever the forward's lse holds (-inf here, finite on the card).
    q, k, v, g = _inputs(2, 4, 6, 2, 2, 16, seed=8)
    kw = dict(causal=True, kv_len=np.array([6, 0], np.int32))
    dq, dk, dv = _port_backward(q, k, v, g, **kw)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert dq[0].abs().max() > 0


def test_flash_backward_on_cpu_is_the_reference_and_counts_no_launch():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 5, 5, 2, 1, 16, seed=9))
    out, lse = tA.mha_reference_with_lse(q, k, v)
    before = tA.flash_bwd_dq.launches, tA.flash_bwd_dkv.launches
    got = tA.flash_backward(q, k, v, out, lse, g)
    want = tA.flash_backward_reference(q, k, v, out, lse, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tA.flash_bwd_dq.launches, tA.flash_bwd_dkv.launches) == before


def test_flash_backward_takes_cpu_or_cuda_tensors_only_and_holds_no_route_state():
    # The wrapper launches or raises: no switch in the module sends a tensor
    # off the CPU to the plain version.
    q, k, v, g = (torch.from_numpy(x).to("meta") for x in _inputs(1, 5, 5, 2, 1, 16, seed=9))
    out, lse = torch.empty_like(q), torch.empty((1, 2, 5), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tA.flash_backward(q, k, v, out, lse, g)
    assert not hasattr(tA, "flash_backward_config") and not hasattr(tA, "_BACKWARD_ROUTE")
