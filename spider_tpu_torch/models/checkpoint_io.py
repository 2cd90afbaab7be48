"""Checkpoint files without extra packages: a reader and a writer of the
safetensors format, and a lazy state dict over a checkpoint file or
directory.

The safetensors format: an 8-byte little-endian header length N, N bytes of
JSON ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` (an
optional ``"__metadata__"`` entry maps strings to strings), then the raw
little-endian tensor bytes, each tensor at ``8 + N + begin``. The reader maps
each tensor's own byte range (``mmap``) and views it with
``torch.frombuffer``: its pages are read when the tensor is first touched,
and the mapping goes when the tensor does, so a loader that drops each
tensor once it is on the device holds about one tensor of the checkpoint in
host memory (mapping the whole file instead would hold every page touched
until the file is closed; on some hosts a first touch brings in the whole
mapping). A tensor whose offset is not a multiple of its element size is
copied out.

``open_state_dict(path)`` selects files by the rule of
spider_tpu/models/convert.py::load_torch_state_dict: a directory loads every
``*.safetensors``, ``*.bin``, ``*.pth`` and ``*.pt`` in it, in sorted order,
a later file's key replacing an earlier one's (so a diffusers folder holding
``diffusion_pytorch_model.bin``, ``.fp16.safetensors`` and ``.safetensors``
ends with every key of the last); ``.bin``/``.pth``/``.pt`` go through
``torch.load(weights_only=True, mmap=True)`` and a ``state_dict`` entry is
unwrapped (torch maps such a file whole). Keys, shapes and dtypes are known
before any tensor is read. Tensors come back in their stored dtype.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch

_DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16,
    "F32": torch.float32, "F64": torch.float64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
CHECKPOINT_SUFFIXES = (".safetensors", ".bin", ".pth", ".pt")


def _require_little_endian() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("the safetensors reader and writer assume a "
                                  "little-endian host")


class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed on open, each tensor read
    on ``get``, which maps that tensor's bytes for as long as it is alive."""

    def __init__(self, path: str):
        _require_little_endian()
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} runs past the file's "
                                 f"{size} bytes")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ValueError(f"{path}: unreadable safetensors header ({e})") from e
        self.metadata = header.pop("__metadata__", None)
        self._data_start = 8 + n
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for key, entry in header.items():
            if entry["dtype"] not in _DTYPES:
                raise NotImplementedError(f"{path}: {key} has dtype {entry['dtype']}, "
                                          f"not one of {sorted(_DTYPES)}")
            dtype, shape = _DTYPES[entry["dtype"]], tuple(int(s) for s in entry["shape"])
            begin, end = (int(o) for o in entry["data_offsets"])
            numel = 1
            for s in shape:
                numel *= s
            if end - begin != numel * dtype.itemsize or begin < 0 or \
                    self._data_start + end > size:
                raise ValueError(f"{path}: {key} ({entry['dtype']} {list(shape)}) has "
                                 f"data_offsets {[begin, end]} that do not fit it or the file")
            self._entries[key] = (dtype, shape, self._data_start + begin, end - begin)
        self._file = None

    def close(self) -> None:
        """Close the file; tensors already returned stay valid."""
        if self._file is not None:
            self._file.close()
            self._file = None

    def keys(self):
        return self._entries.keys()

    def shape(self, key: str) -> Tuple[int, ...]:
        return self._entries[key][1]

    def dtype(self, key: str) -> torch.dtype:
        return self._entries[key][0]

    def get(self, key: str) -> torch.Tensor:
        dtype, shape, offset, nbytes = self._entries[key]
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        start = offset // mmap.ALLOCATIONGRANULARITY * mmap.ALLOCATIONGRANULARITY
        if self._file is None:
            self._file = open(self.path, "rb")
        # A private writable mapping: torch.frombuffer wants a writable
        # buffer, and nothing is ever written to the file. It stays valid
        # after the file is closed.
        buf = mmap.mmap(self._file.fileno(), offset + nbytes - start, offset=start,
                        access=mmap.ACCESS_COPY)
        if offset % dtype.itemsize == 0:
            flat = torch.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize,
                                    offset=offset - start)
        else:                       # unaligned for its dtype: copy the bytes out
            flat = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                                    offset=offset - start).clone().view(dtype)
        return flat.reshape(shape)


def _load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: holds a {type(sd).__name__}, not a state dict")
    return sd


def checkpoint_files(path: str):
    """The files `path` names, in load order (see the module docstring)."""
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(CHECKPOINT_SUFFIXES)]
        if not files:
            raise FileNotFoundError(f"{path}: no {'/'.join(CHECKPOINT_SUFFIXES)} file in it")
        return files
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return [path]


class LazyStateDict(Mapping):
    """key -> tensor over the files of a checkpoint, each tensor read when
    it is looked up. ``shape``, ``dtype`` and ``source`` answer without
    reading. A context manager: leaving it closes the files (tensors already
    returned stay valid)."""

    def __init__(self, path: str):
        self.path = path
        self._where: Dict[str, Tuple[object, str]] = {}
        for f in checkpoint_files(path):
            if f.endswith(".safetensors"):
                st = SafetensorsFile(f)
                for k in st.keys():
                    self._where[k] = (st, f)
            else:
                sd = _load_torch_file(f)
                for k in sd:
                    self._where[k] = (sd, f)

    def __getitem__(self, key: str) -> torch.Tensor:
        try:
            src, f = self._where[key]
        except KeyError:
            raise KeyError(f"{key!r} is not in the checkpoint at {self.path} "
                           f"({len(self._where)} keys)") from None
        if isinstance(src, SafetensorsFile):
            return src.get(key)
        t = src[key]
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{f}: {key} holds a {type(t).__name__}, not a tensor")
        return t

    def __enter__(self) -> "LazyStateDict":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for src, _ in self._where.values():
            if isinstance(src, SafetensorsFile):
                src.close()

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where

    def source(self, key: str) -> str:
        """The file `key` is read from."""
        return self._where[key][1]

    def shape(self, key: str) -> Tuple[int, ...]:
        src = self._where[key][0]
        return src.shape(key) if isinstance(src, SafetensorsFile) else tuple(src[key].shape)

    def dtype(self, key: str) -> torch.dtype:
        src = self._where[key][0]
        return src.dtype(key) if isinstance(src, SafetensorsFile) else src[key].dtype


def open_state_dict(path: str) -> LazyStateDict:
    return LazyStateDict(path)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` as one ``.safetensors`` file; returns its size in
    bytes. Tensors are laid out by element size, largest first (then by
    name), so every offset is a multiple of its element size, as the
    safetensors library lays them out; the header is padded with spaces to
    a multiple of 8 bytes."""
    _require_little_endian()
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for k in order:
        t = tensors[k]
        if t.dtype not in _NAMES:
            raise NotImplementedError(f"{k}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            t = tensors[k].detach()
            if t.numel():
                f.write(t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def save_sharded(shards: Sequence[Union[Mapping[str, torch.Tensor],
                                         Callable[[], Mapping[str, torch.Tensor]]]],
                 directory: str, prefix: str = "model") -> Dict[str, str]:
    """Write shards of {key: tensor} as ``<prefix>-0000k-of-0000n.safetensors``
    plus ``<prefix>.safetensors.index.json`` (the HF layout of a sharded
    checkpoint). A shard may be given as a function that makes it, so that
    only one shard is in memory at a time. Returns the index's weight map."""
    n = len(shards)
    weight_map: Dict[str, str] = {}
    total = 0
    for i, shard in enumerate(shards):
        name = f"{prefix}-{i + 1:05d}-of-{n:05d}.safetensors"
        if callable(shard):
            shard = shard()
        total += sum(t.numel() * t.element_size() for t in shard.values())
        save_file(shard, os.path.join(directory, name), metadata={"format": "pt"})
        weight_map.update((k, name) for k in shard)
    with open(os.path.join(directory, f"{prefix}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return weight_map
