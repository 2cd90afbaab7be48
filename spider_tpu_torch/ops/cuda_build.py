"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel lives in ``spider_tpu_torch/csrc/<name>.cu`` behind a plain C
entry point. At first use it is compiled for ``sm_90a`` into
``spider_tpu_torch/build/lib<name>-<hash>.so``, where the hash
(``source_digest``) covers the source, every header ``csrc/*.cuh`` and the
flags, so an edited source or header never loads a stale library. The
build runs only when a kernel is launched on a CUDA tensor (or ``load_all``
is called), never on import.
nvcc's output, with ptxas's registers, shared memory and spills per kernel,
is kept beside the library as ``lib<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
# The sources include the headers beside them ("hopper.cuh") and nothing
# outside the CUDA toolkit, so no include path is given; one added here
# enters the digest with the other flags.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds nvcc took for each library built by this process; read by
# chip_smoke.py.
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def source_digest(name: str, csrc_dir: str = CSRC_DIR, flags=NVCC_FLAGS) -> str:
    """16 hex digits over csrc/<name>.cu, every csrc/*.cuh (by name and
    content, in sorted order) and the compiler flags, include paths among
    them. Needs no nvcc."""
    digest = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))
    for path in [os.path.join(csrc_dir, f"{name}.cu"), *headers]:
        with open(path, "rb") as f:
            data = f.read()
        digest.update(f"{os.path.basename(path)}:{len(data)}:".encode())
        digest.update(data)
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; return its path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}-{source_digest(name)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """Build the named kernels at once, one nvcc process each, then load
    them."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build, names))
    return {name: load(name) for name in names}
