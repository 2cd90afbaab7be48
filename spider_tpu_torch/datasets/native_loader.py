"""ctypes bindings for the native threaded tar-shard reader
(``native/tarreader.cpp``, counterpart of spider_tpu/datasets/native_loader.py).
The fast path for TarShardSource: the tar walk and the prefetch queue run in
C++ threads off the GIL; Python only decodes.

The library is compiled with g++ at first use into
``spider_tpu_torch/build/libspidertar-<hash>.so``, where the hash covers the
source and the flags (as ``ops/cuda_build.py`` keys the kernels), so an
edited source never loads a stale library. Nothing is written into
``native/``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterator

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "tarreader.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib = None
# Path of the library this process loaded, or None; read by chip_smoke.py.
LOADED_PATH = None


class _TrMember(ctypes.Structure):
    _fields_ = [("ext", ctypes.c_char_p),
                ("data", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_uint64),
                ("key", ctypes.c_char_p)]


def source_digest(source: str = SOURCE, flags=CXX_FLAGS) -> str:
    """16 hex digits over the reader's source and the compiler flags."""
    digest = hashlib.sha256()
    with open(source, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libspidertar-{source_digest()}.so")


def build() -> str:
    """Compile the reader unless its library exists; return its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native tar reader")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load_library(build_if_missing: bool = True):
    global _lib, LOADED_PATH
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        if not build_if_missing:
            raise FileNotFoundError(path)
        build()
    lib = ctypes.CDLL(path)
    lib.tr_open.restype = ctypes.c_void_p
    lib.tr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tr_next.restype = ctypes.c_int
    lib.tr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_TrMember),
                            ctypes.c_int]
    lib.tr_close.argtypes = [ctypes.c_void_p]
    _lib, LOADED_PATH = lib, path
    return lib


class NativeTarSource:
    """Iterates webdataset-style samples {ext: bytes, '__key__': str} from
    tar shards using the C++ reader. API-compatible with TarShardSource for
    the byte-level contract (decoding happens in the dataset transform)."""

    MAX_MEMBERS = 64

    def __init__(self, pattern, n_threads: int = 2, queue_capacity: int = 64,
                 loop: bool = False, decode: bool = True):
        self.shards = sorted(glob.glob(pattern)) if isinstance(pattern, str) \
            else list(pattern)
        if not self.shards:
            raise FileNotFoundError(f"no shards match {pattern}")
        self.n_threads = n_threads
        self.queue_capacity = queue_capacity
        self.loop = loop
        self.decode = decode
        load_library()

    def __iter__(self) -> Iterator[Dict]:
        from spider_tpu_torch.datasets.backends import _decode_member

        lib = load_library()
        arr = (ctypes.c_char_p * len(self.shards))(
            *[s.encode() for s in self.shards])
        handle = lib.tr_open(arr, len(self.shards), self.n_threads,
                             self.queue_capacity, int(self.loop))
        members = (_TrMember * self.MAX_MEMBERS)()
        try:
            while True:
                n = lib.tr_next(handle, members, self.MAX_MEMBERS)
                if n < 0:
                    raise RuntimeError(
                        "native tar reader: shard parse error (malformed "
                        f"size field or truncated member) in {self.shards}")
                if n == 0:
                    break
                sample: Dict = {}
                for i in range(n):
                    m = members[i]
                    data = ctypes.string_at(m.data, m.size)
                    ext = m.ext.decode()
                    sample["__key__"] = m.key.decode()
                    if self.decode:
                        decoded = _decode_member(f"x.{ext}", data)
                        if decoded is not None:
                            sample[ext] = decoded
                    else:
                        sample[ext] = data
                if len(sample) > 1:
                    yield sample
        finally:
            lib.tr_close(handle)
