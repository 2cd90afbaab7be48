"""The scoped overrides of the kernels' routes (``ops/launch.py::scoped_mode``):
each of the six takes only its own modes, holds inside its block on its own
thread, and is undone when the block ends, also by an exception."""

import importlib
import threading

import pytest

# (module, override, getter, modes: the default first)
OVERRIDES = [
    ("spider_tpu_torch.ops.attention", "spatial_flash_config", "_spatial_mode",
     ("auto", "einsum")),
    ("spider_tpu_torch.ops.group_norm", "group_norm_config", "_mode", ("auto", "plain")),
    ("spider_tpu_torch.ops.quant", "int4_matmul_config", "_mode", ("auto", "plain")),
    ("spider_tpu_torch.ops.temporal_attention", "temporal_attention_config", "_mode",
     ("auto", "plain")),
    ("spider_tpu_torch.ops.paged_attention", "paged_decode_config", "_mode", ("auto", "plain")),
    ("spider_tpu_torch.models.unet2d", "story_bank_config", "_story_bank_impl",
     ("split", "self_only")),
]


@pytest.mark.parametrize("module,name,getter,modes", OVERRIDES, ids=[o[1] for o in OVERRIDES])
def test_an_override_holds_in_its_scope_and_thread_only(module, name, getter, modes):
    mod = importlib.import_module(module)
    config, get = getattr(mod, name), getattr(mod, getter)
    default, other = modes
    assert get() == default
    with pytest.raises(ValueError):
        with config("fast"):
            pass
    assert get() == default
    for mode in modes:
        with config(mode):
            assert get() == mode
    seen = []
    with config(other):
        thread = threading.Thread(target=lambda: seen.append(get()))
        thread.start()
        thread.join()
        with config(default):
            assert get() == default
        assert get() == other
    assert seen == [default]
    assert get() == default
    with pytest.raises(RuntimeError):
        with config(other):
            raise RuntimeError("inside the override")
    assert get() == default
