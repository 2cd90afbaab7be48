"""The port's checkpoint files (spider_tpu_torch/models/checkpoint_io.py):
its safetensors reader and writer held to the ``safetensors`` library (the
tests that need the library skip where it is absent), tensors at unaligned
offsets, a sharded directory with its index, ``.bin`` files through
``torch.load``, the sorted-overwrite rule of a directory, and the errors an
unreadable file raises. Every comparison is bit for bit."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from spider_tpu_torch.models import checkpoint_io as io
from spider_tpu_torch.models.convert import load_torch_state_dict

DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.int32,
          torch.int64, torch.bool, torch.uint8, torch.float64, torch.int16)


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5 + i) if i % 2 else (7 + i,)
        if dt.is_floating_point:
            out[f"t.{i}.{str(dt)[6:]}"] = torch.randn(shape, generator=g).to(dt)
        elif dt == torch.bool:
            out[f"t.{i}.bool"] = torch.randint(0, 2, shape, generator=g).bool()
        else:
            out[f"t.{i}.{str(dt)[6:]}"] = torch.randint(-100, 100, shape, generator=g).to(dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4)
    return out


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _safetensors_torch():
    return pytest.importorskip("safetensors.torch")


def test_writer_is_read_by_the_safetensors_library(tmp_path):
    st = _safetensors_torch()
    want = _tensors()
    path = str(tmp_path / "port.safetensors")
    io.save_file(want, path, metadata={"format": "pt"})
    got = st.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])


def test_reader_reads_the_safetensors_library(tmp_path):
    st = _safetensors_torch()
    want = _tensors(1)
    path = str(tmp_path / "lib.safetensors")
    st.save_file(want, path, metadata={"who": "library"})
    f = io.SafetensorsFile(path)
    assert f.metadata == {"who": "library"}
    assert sorted(f.keys()) == sorted(want)
    for k in want:
        assert f.shape(k) == tuple(want[k].shape) and f.dtype(k) == want[k].dtype
        _same(f.get(k), want[k])
    f.close()


def test_round_trip_and_alignment(tmp_path):
    want = _tensors(2)
    path = str(tmp_path / "a.safetensors")
    size = io.save_file(want, path)
    assert size == os.path.getsize(path)
    f = io.SafetensorsFile(path)
    for k in want:
        _, _, offset, _ = f._entries[k]
        assert offset % want[k].element_size() == 0     # laid out largest element first
        _same(f.get(k), want[k])
    f.close()


def _write_raw(path, entries):
    """A safetensors file laid out in the given order, padding nothing:
    entries [(name, tensor)]."""
    header, blobs, offset = {}, [], 0
    names = {v: k for k, v in io._DTYPES.items()}
    for name, t in entries:
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_unaligned_offsets_are_copied_out(tmp_path):
    g = torch.Generator().manual_seed(3)
    entries = [("flag", torch.tensor([True, False, True])),            # 3 bytes
               ("w", torch.randn(4, 3, generator=g)),                   # at offset 3
               ("h", torch.randn(5, generator=g).to(torch.bfloat16)),
               ("i", torch.arange(6, dtype=torch.int64).reshape(2, 3))]
    path = str(tmp_path / "odd.safetensors")
    _write_raw(path, entries)
    f = io.SafetensorsFile(path)
    assert f._entries["w"][2] % 4 == 3
    for name, t in entries:
        got = f.get(name)
        _same(got, t)
        assert got.data_ptr() % t.element_size() == 0
    f.close()
    try:
        import safetensors.numpy as snp
    except ImportError:
        return
    lib = snp.load_file(path)       # the library reads the same bytes
    np.testing.assert_array_equal(lib["w"], entries[1][1].numpy())


@pytest.mark.parametrize("damage", ["short", "header_length", "json", "offsets", "dtype"])
def test_unreadable_files_raise(tmp_path, damage):
    path = str(tmp_path / "bad.safetensors")
    io.save_file({"w": torch.ones(4, 4)}, path)
    raw = (tmp_path / "bad.safetensors").read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    head = raw[8:8 + n]
    if damage == "short":
        raw = raw[:5]
    elif damage == "header_length":
        raw = struct.pack("<Q", len(raw)) + raw[8:]
    elif damage == "json":
        raw = raw[:8] + b"{" * n + raw[8 + n:]
    elif damage == "offsets":
        raw = raw[:8] + head.replace(b"[0,64]", b"[0,60]") + raw[8 + n:]
    else:
        raw = raw[:8] + head.replace(b'"F32"', b'"F99"') + raw[8 + n:]
    (tmp_path / "bad.safetensors").write_bytes(raw)
    with pytest.raises((ValueError, NotImplementedError)):
        io.SafetensorsFile(path)


def test_sharded_directory_with_index(tmp_path):
    want = _tensors(4)
    keys = sorted(want)
    shards = [{k: want[k] for k in keys[:5]}, lambda: {k: want[k] for k in keys[5:]}]
    weight_map = io.save_sharded(shards, str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors",
                     "model.safetensors.index.json"]
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert index["weight_map"] == weight_map and sorted(weight_map) == keys
    assert index["metadata"]["total_size"] == sum(t.numel() * t.element_size()
                                                  for t in want.values())
    with io.open_state_dict(str(tmp_path)) as sd:
        assert sorted(sd) == keys
        for k in keys:
            assert os.path.basename(sd.source(k)) == weight_map[k]
            assert sd.shape(k) == tuple(want[k].shape) and sd.dtype(k) == want[k].dtype
            first = sd[k]
            _same(first, want[k])
            del first                       # its mapping goes with it
            _same(sd[k], want[k])           # and a second read maps the bytes again
        kept = sd[keys[0]]
    _same(kept, want[keys[0]])              # a tensor outlives the closed files
    eager = load_torch_state_dict(str(tmp_path))
    assert sorted(eager) == keys
    for k in keys:
        _same(eager[k], want[k])


def test_bin_and_pth_through_torch_load(tmp_path):
    want = {k: v for k, v in _tensors(5).items()}
    torch.save(want, tmp_path / "pytorch_model.bin")
    torch.save({"state_dict": want, "epoch": 3}, tmp_path / "wrapped.pth")
    for name in ("pytorch_model.bin", "wrapped.pth"):
        sd = io.open_state_dict(str(tmp_path / name))
        assert sorted(sd) == sorted(want)
        for k in want:
            assert sd.shape(k) == tuple(want[k].shape) and sd.dtype(k) == want[k].dtype
            _same(sd[k], want[k])
    torch.save([1, 2], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="not a state dict"):
        io.open_state_dict(str(tmp_path / "list.pt"))


def test_directory_files_load_in_sorted_order_later_keys_win(tmp_path):
    # A diffusers folder holding the three usual forms of one model: the
    # reference loads them all in sorted order, so every key shared by the
    # three comes from diffusion_pytorch_model.safetensors, the last.
    base = {"a": torch.full((2,), 1.0), "b": torch.full((2,), 1.0), "only_bin": torch.ones(1)}
    torch.save(base, tmp_path / "diffusion_pytorch_model.bin")
    io.save_file({"a": torch.full((2,), 2.0, dtype=torch.float16),
                  "b": torch.full((2,), 2.0, dtype=torch.float16), "only_fp16": torch.ones(1)},
                 str(tmp_path / "diffusion_pytorch_model.fp16.safetensors"))
    io.save_file({"a": torch.full((2,), 3.0)},
                 str(tmp_path / "diffusion_pytorch_model.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "notes.txt").write_text("ignored")
    assert [os.path.basename(f) for f in io.checkpoint_files(str(tmp_path))] == [
        "diffusion_pytorch_model.bin", "diffusion_pytorch_model.fp16.safetensors",
        "diffusion_pytorch_model.safetensors"]
    with io.open_state_dict(str(tmp_path)) as sd:
        assert sorted(sd) == ["a", "b", "only_bin", "only_fp16"]
        _same(sd["a"], torch.full((2,), 3.0))
        _same(sd["b"], torch.full((2,), 2.0, dtype=torch.float16))
        assert sd.source("only_bin").endswith(".bin")
    eager = load_torch_state_dict(str(tmp_path))
    _same(eager["a"], torch.full((2,), 3.0))


def test_missing_paths_and_keys_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        io.open_state_dict(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        io.open_state_dict(str(tmp_path))
    io.save_file({"w": torch.ones(2)}, str(tmp_path / "m.safetensors"))
    with pytest.raises(KeyError, match="not in the checkpoint"), \
            io.open_state_dict(str(tmp_path)) as sd:
        sd["v"]
