"""CPU checks of the rules that pick a flash kernel, a temporal kernel and a
UNet attention path on the card, and of the kernel library's build digest.

``flash_route`` (ops/attention.py) names the forward, dq and dk/dv kernel a
call takes from its dtype and head dim; ``tattn_route``
(ops/temporal_attention.py) the temporal kernel from its dtype;
``spatial_flash_predicate`` (ops/attention.py) says where attention on
[B, T, C] projections (the UNets', Grounding DINO's, SAM's) goes to the flash
kernel. All are pure functions, so the CPU can
hold them to every shape the main paths run. Nothing here launches a kernel:
on CPU tensors the wrappers take the plain versions, whatever the rules say.
"""

import os
import shutil

import pytest
import torch

from spider_tpu_torch.models.unet2d import unet_audioldm, unet_sd15
from spider_tpu_torch.models.unet3d import UNet3DConfig
from spider_tpu_torch.ops import attention as A
from spider_tpu_torch.ops import cuda_build
from spider_tpu_torch.ops import temporal_attention as TA
from spider_tpu_torch.ops.attention import spatial_flash_config, spatial_flash_predicate

# (name, dtype, head dim): every flash shape of the main paths.
MAIN_PATH = [("llama3_8b prefill / train", torch.bfloat16, 128),
             ("sd15 L0", torch.bfloat16, 40), ("sd15 L1", torch.bfloat16, 80),
             ("zeroscope L0", torch.bfloat16, 40), ("zeroscope L1", torch.bfloat16, 80),
             ("audioldm L0", torch.bfloat16, 16), ("audioldm L1", torch.bfloat16, 32),
             ("audioldm L2", torch.bfloat16, 48), ("audioldm L3", torch.bfloat16, 80)]


@pytest.mark.parametrize("name,dtype,D", MAIN_PATH, ids=[m[0] for m in MAIN_PATH])
def test_main_path_shapes_take_the_wgmma_route(name, dtype, D):
    assert A.flash_route(dtype, D) == "wgmma"


@pytest.mark.parametrize("dtype,D", [(torch.float32, 128), (torch.float32, 40),
                                     (torch.bfloat16, 36), (torch.bfloat16, 100),
                                     (torch.bfloat16, 1), (torch.float32, 7)])
def test_fp32_and_odd_head_dims_take_the_general_route(dtype, D):
    assert A.flash_route(dtype, D) == "mma"


def test_route_is_one_of_the_counted_routes():
    assert set(A.ROUTES) == {"wgmma", "mma"}
    assert set(A.flash_attention.route_launches) == set(A.ROUTES)
    assert set(A.flash_bwd_dq.route_launches) == set(A.ROUTES)
    assert set(A.flash_bwd_dkv.route_launches) == set(A.ROUTES)
    for D in range(1, A.MAX_HEAD_DIM + 1):
        for dtype in (torch.bfloat16, torch.float32):
            assert A.flash_route(dtype, D) in A.ROUTES
            assert (A.flash_route(dtype, D) == "wgmma") == (dtype == torch.bfloat16
                                                            and D % 8 == 0)


def test_cpu_tensors_take_the_plain_version_whatever_the_route():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 9, 2, 16), generator=g) for _ in range(3))
    before = A.flash_attention.launches, dict(A.flash_attention.route_launches)
    for route in (None, "wgmma", "mma"):
        out = A.flash_attention(q, k, v, causal=True, route=route)
        assert torch.equal(out, A.mha_reference(q, k, v, causal=True))
    assert (A.flash_attention.launches, A.flash_attention.route_launches) == before


def test_resolve_route_raises_and_never_falls_back():
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    assert A._resolve_route(None, (q, q, q)) == "wgmma"
    assert A._resolve_route("mma", (q, q, q)) == "mma"
    with pytest.raises(ValueError):
        A._resolve_route("wgmma", (q.float(),) * 3)
    with pytest.raises(ValueError):
        A._resolve_route("wgmma", (torch.zeros((1, 4, 2, 36), dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError):
        A._resolve_route("tma", (q, q, q))
    odd = torch.zeros(1 * 4 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].reshape(1, 4, 2, 64)
    with pytest.raises(ValueError):           # 2 bytes off a 16-byte boundary
        A._resolve_route("wgmma", (q, odd, q))


def _bwd_args(dtype, D, T=9, S=12):
    """CPU arguments of flash_bwd_dq / flash_bwd_dkv at a tiny size."""
    g = torch.Generator().manual_seed(2)
    mk = lambda *s: torch.randn(s, generator=g).to(dtype)
    q, k, v, do = mk(1, T, 4, D), mk(1, S, 2, D), mk(1, S, 2, D), mk(1, T, 4, D)
    lse, delta = torch.zeros((1, 4, T)), torch.zeros((1, 4, T))
    live, off = A._live_and_offset(1, T, S, None, None, "cpu")
    return q, k, v, do, lse, delta, live, off, True, None


@pytest.mark.parametrize("name,dtype,D", MAIN_PATH, ids=[m[0] for m in MAIN_PATH])
def test_flash_bwd_dq_follows_flash_route(name, dtype, D):
    # dq resolves its route from (q, k, v, dO) exactly as dk/dv does
    q, k, v, do = _bwd_args(dtype, D)[:4]
    assert A._resolve_route(None, (q, k, v, do)) == A.flash_route(dtype, D) == "wgmma"
    assert A._resolve_route("mma", (q, k, v, do)) == "mma"


@pytest.mark.parametrize("dtype,D", [(torch.float32, 128), (torch.float32, 40),
                                     (torch.bfloat16, 36), (torch.bfloat16, 100)])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_named_wgmma_backward_raises_on_fp32_and_odd_head_dims(kernel, dtype, D):
    # the route is resolved before anything is launched: no fallback to "mma"
    before = A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches
    with pytest.raises(ValueError, match="wgmma"):
        getattr(A, kernel)(*_bwd_args(dtype, D), route="wgmma")
    assert (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("route", [None, "wgmma", "mma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_on_cpu_takes_the_reference_whatever_the_route(route, dtype):
    q, k, v, do = _bwd_args(dtype, 16)[:4]
    out, lse = A.mha_reference_with_lse(q, k, v, causal=True)
    before = (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches,
              dict(A.flash_bwd_dq.route_launches), dict(A.flash_bwd_dkv.route_launches))
    got = A.flash_backward(q, k, v, out, lse, do, causal=True, route=route)
    want = A.flash_backward_reference(q, k, v, out, lse, do, causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches,
            A.flash_bwd_dq.route_launches, A.flash_bwd_dkv.route_launches) == before


# ---------------------------------------------------------------------------
# tattn_route: the temporal kernel's two forms
# ---------------------------------------------------------------------------

def test_tattn_route_is_pure_and_counted():
    assert TA.ROUTES == ("ring", "simple")
    assert set(TA.temporal_attention.route_launches) == set(TA.ROUTES)
    assert TA.tattn_route(torch.bfloat16) == "ring"        # what UNet3D runs
    for dtype in (torch.float32, torch.float16, torch.float64):
        assert TA.tattn_route(dtype) == "simple"


@pytest.mark.parametrize("layout", TA.LAYOUTS)
def test_tattn_on_cpu_takes_the_reference_and_counts_nothing(layout):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 8, 40, 64), generator=g) for _ in range(3))
    before = TA.temporal_attention.launches, dict(TA.temporal_attention.route_launches)
    out = TA.temporal_attention(q, k, v, 8, layout=layout)      # inside the predicate
    assert TA.kernel_predicate(8, 8, 40, 64)
    assert torch.equal(out, TA.temporal_attention_reference(q, k, v, 8, layout=layout))
    assert (TA.temporal_attention.launches, TA.temporal_attention.route_launches) == before


def test_named_tattn_route_raises_and_never_falls_back():
    q = torch.zeros((1, 8, 40, 64))
    before = TA.temporal_attention.launches
    with pytest.raises(ValueError, match="ring"):             # fp32 belongs to "simple"
        TA.temporal_attention_kernel(q, q, q, 8, route="ring")
    with pytest.raises(ValueError, match="route"):
        TA.temporal_attention_kernel(q.bfloat16(), q.bfloat16(), q.bfloat16(), 8, route="tma")
    for route in (None, "simple"):                            # a CPU tensor: no kernel
        with pytest.raises(ValueError, match="CUDA"):
            TA.temporal_attention_kernel(q, q, q, 8, route=route)
    assert TA.temporal_attention.launches == before


@pytest.mark.parametrize("layout,scale", [("bfpc", None), ("bpfc", 0.3)])
def test_tattn_function_takes_the_plain_forms_gradient(monkeypatch, layout, scale):
    # On CUDA tensors temporal_attention launches the kernel through
    # TemporalAttentionFunction. Here its launcher is the plain form, so the
    # Function runs on CPU tensors: q, k and v get gradients, equal to
    # autograd's through the plain form, and the backward launches nothing.
    launched = []

    def launcher(q, k, v, heads, *, scale=None, layout="bfpc", route=None):
        launched.append(route)
        return TA.temporal_attention_reference(q, k, v, heads, scale=scale, layout=layout)

    monkeypatch.setattr(TA, "temporal_attention_kernel", launcher)
    g = torch.Generator().manual_seed(5)
    shape = (2, 40, 8, 64) if layout == "bpfc" else (2, 8, 40, 64)
    q, k, v, dout = (torch.randn(shape, generator=g) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = TA.TemporalAttentionFunction.apply(*leaves, 8, scale, layout)
    assert out.grad_fn is not None and launched == [None]
    grads = torch.autograd.grad(out, leaves, dout)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want_out = TA.temporal_attention_reference(*plain, 8, scale=scale, layout=layout)
    want = torch.autograd.grad(want_out, plain, dout)
    assert torch.equal(out, want_out.detach())
    for got, exp in zip(grads, want):
        assert got.shape == exp.shape and got.abs().max() > 0
        torch.testing.assert_close(got, exp, atol=1e-6, rtol=1e-6)
    assert launched == [None]                  # the backward launched no kernel


# ---------------------------------------------------------------------------
# spatial_flash_predicate at every UNet shape the H100 run times: (model,
# level, B, T, cross-attention S, heads, D, self routed, cross routed), B the
# CFG batch (times ZeroScope's 16 frames). The expected routing is the one the
# card's rows support (chip_smoke.py, phase unet_routing).
# ---------------------------------------------------------------------------

UNET_SHAPES = [
    ("sd15", "L0", 2, 4096, 77, 8, 40), ("sd15", "L1", 2, 1024, 77, 8, 80),
    ("sd15", "L2", 2, 256, 77, 8, 160),
    ("audioldm", "L0", 2, 8192, 1, 8, 16), ("audioldm", "L1", 2, 2048, 1, 8, 32),
    ("audioldm", "L2", 2, 512, 1, 8, 48), ("audioldm", "L3", 2, 128, 1, 8, 80),
    ("audioldm", "mid", 2, 128, 1, 8, 80),
    ("zeroscope", "L0", 32, 2880, 77, 8, 40), ("zeroscope", "L1", 32, 720, 77, 8, 80),
    ("zeroscope", "L2", 32, 180, 77, 8, 160), ("zeroscope", "mid", 32, 45, 77, 8, 160),
]


def test_unet_shapes_are_the_configs():
    def shapes(cfg, h, w):
        n = len(cfg.block_out_channels)
        return {lvl: ((h >> lvl) * (w >> lvl),
                      cfg.block_out_channels[lvl] // cfg.num_attention_heads[lvl])
                for lvl in range(n)}

    for model, cfg, h, w in (("sd15", unet_sd15(), 64, 64), ("audioldm", unet_audioldm(), 256, 32),
                             ("zeroscope", UNet3DConfig(), 40, 72)):
        got = shapes(cfg, h, w)
        for m, level, _, T, _, H, D in UNET_SHAPES:
            if m == model:
                lvl = 3 if level == "mid" else int(level[1])
                assert got[lvl] == (T, D), (m, level)
                assert cfg.num_attention_heads[lvl] == H


# (self-attention, cross-attention): flash wherever the kernels take the head.
EXPECTED_ROUTING = {(s[0], s[1]): (s[6] <= 128, s[6] <= 128) for s in UNET_SHAPES}


@pytest.mark.parametrize("model,level,B,T,S,H,D", UNET_SHAPES,
                         ids=[f"{s[0]}-{s[1]}" for s in UNET_SHAPES])
def test_spatial_flash_predicate_at_the_timed_shapes(model, level, B, T, S, H, D):
    want_self, want_cross = EXPECTED_ROUTING[(model, level)]
    assert spatial_flash_predicate(B, T, T, H, D) is want_self
    assert spatial_flash_predicate(B, T, S, H, D) is want_cross
    if D > A.MAX_HEAD_DIM:          # the kernels take no such head
        assert not want_self and not want_cross


def test_spatial_flash_predicate_is_a_pure_rule_with_an_override():
    assert spatial_flash_predicate(2, 4096, 4096, 8, 40) is True
    assert spatial_flash_predicate(2, 4096, 4096, 8, 160) is False
    # the override changes what A.attention does, not what the rule says
    with spatial_flash_config("einsum"):
        assert spatial_flash_predicate(2, 4096, 4096, 8, 40) is True
    with pytest.raises(ValueError):
        with spatial_flash_config("flash"):
            pass


def test_only_the_unets_route_by_the_predicate():
    """Every model takes its attention on projections from ops/attention.py.
    The UNets, Grounding DINO and SAM call ``attention``, routed by the
    predicate; the aligners (fp32, trained), ImageBind and PhotoMaker's ID
    encoder call ``plain_attention``, whatever the predicate says of their
    shapes. No model keeps a routing of its own."""
    from spider_tpu_torch.models import aligners, dino, imagebind, photomaker, sam, unet2d

    for routed in (unet2d, dino, sam):
        assert routed.attention is A.attention and not hasattr(routed, "plain_attention")
    assert unet2d.attention_with_lse is A.attention_with_lse
    for plain in (aligners, imagebind, photomaker):
        assert plain.plain_attention is A.plain_attention
        assert not hasattr(plain, "attention")
    for model in (unet2d, dino, sam, aligners, imagebind, photomaker):
        assert not {"_attention", "_attention_lse", "spatial_flash_predicate",
                    "spatial_flash_config"} & set(vars(model)), model.__name__
    assert spatial_flash_predicate(4, 257, 257, 16, 80)        # ImageBind-huge's shape
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, 10, 32), generator=g) for _ in range(3))
    assert torch.equal(A.attention(q, k, v, 4), A.plain_attention(q, k, v, 4))


# ---------------------------------------------------------------------------
# cuda_build's digest
# ---------------------------------------------------------------------------

@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "one.cu").write_text('#include "shared.cuh"\nint one;\n')
    (d / "two.cu").write_text("int two;\n")
    (d / "shared.cuh").write_text("// shared\n")
    return str(d)


def test_digest_covers_the_source_the_headers_and_the_flags(csrc):
    flags = cuda_build.NVCC_FLAGS
    base = cuda_build.source_digest("one", csrc, flags)
    assert base == cuda_build.source_digest("one", csrc, flags)          # stable
    assert len(base) == 16 and int(base, 16) >= 0
    assert base != cuda_build.source_digest("two", csrc, flags)
    with open(os.path.join(csrc, "shared.cuh"), "a") as f:                # an edited header
        f.write("// edited\n")
    edited = cuda_build.source_digest("one", csrc, flags)
    assert edited != base
    assert cuda_build.source_digest("two", csrc, flags) != base          # every source sees it
    with open(os.path.join(csrc, "new.cuh"), "w") as f:                   # a new header
        f.write("")
    added = cuda_build.source_digest("one", csrc, flags)
    assert added not in (base, edited)
    include = flags + ("-I", "/usr/local/cutlass/include")                # an include flag
    assert cuda_build.source_digest("one", csrc, include) != added
    with open(os.path.join(csrc, "one.cu"), "a") as f:                    # the source itself
        f.write("int more;\n")
    assert cuda_build.source_digest("one", csrc, flags) != added


def test_digest_of_the_package_sources_names_the_library():
    names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    assert {"flash_fwd", "flash_bwd", "tattn_fwd", "paged_decode", "int4_matmul",
            "wgmma_probe"} <= set(names)
    assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, "hopper.cuh"))
    digests = {n: cuda_build.source_digest(n) for n in names}
    assert len(set(digests.values())) == len(names)


def test_generated_wgmma_header_is_what_its_generator_writes():
    import subprocess
    import sys

    gen = os.path.join(cuda_build.CSRC_DIR, "gen_wgmma.py")
    out = subprocess.run([sys.executable, gen], capture_output=True, text=True, check=True).stdout
    with open(os.path.join(cuda_build.CSRC_DIR, "hopper_wgmma.cuh")) as f:
        assert f.read() == out


def test_build_needs_nvcc_only_when_called():
    # Importing the modules built nothing; without a toolkit build() says so.
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    env = {k: os.environ.pop(k) for k in ("CUDA_HOME", "CUDA_PATH") if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_build.find_nvcc()
    finally:
        os.environ.update(env)
