"""The port's native tar reader (``datasets/native_loader.py``) on the CPU:
built from ``native/tarreader.cpp`` with g++ into the port's build directory
(``native/`` is left as it was), equal to the Python reader, loop mode, GNU
and PAX long names, and the corrupt-size and malformed-pax errors."""

import hashlib
import io
import itertools
import os
import tarfile

import pytest

from spider_tpu_torch.datasets import native_loader as NL
from spider_tpu_torch.datasets.backends import TarShardSource

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")


def _native_tree():
    out = {}
    for name in sorted(os.listdir(NATIVE)):
        with open(os.path.join(NATIVE, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _make_shard(path, n, prefix=""):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            for ext, payload in (("txt", f"caption {prefix}{i}".encode()),
                                 ("json", b'{"a": 1}')):
                info = tarfile.TarInfo(f"{prefix}{i:05d}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))


@pytest.fixture(scope="module")
def lib():
    if NL.shutil.which("g++") is None and NL.shutil.which("c++") is None:
        pytest.skip("no C++ compiler here to build the native tar reader")
    return NL.load_library()


def test_library_builds_in_the_ports_build_directory_and_native_is_unchanged(tmp_path,
                                                                              monkeypatch):
    before = _native_tree()
    assert NL.library_path().startswith(os.path.join(ROOT, "spider_tpu_torch", "build", ""))
    monkeypatch.setattr(NL, "BUILD_DIR", str(tmp_path / "build"))
    if NL.shutil.which("g++") is None and NL.shutil.which("c++") is None:
        pytest.skip("no C++ compiler here to build the native tar reader")
    path = NL.build()
    assert os.path.dirname(path) == str(tmp_path / "build")
    assert os.path.basename(path) == f"libspidertar-{NL.source_digest()}.so"
    assert NL.build() == path                    # built once: found the second time
    assert os.listdir(tmp_path / "build") == [os.path.basename(path)]
    assert _native_tree() == before
    # the digest follows the source and the flags
    assert NL.source_digest(flags=NL.CXX_FLAGS + ("-g",)) != NL.source_digest()


def test_native_reader_reads_all_samples(lib, tmp_path):
    _make_shard(tmp_path / "a.tar", 5, "a")
    _make_shard(tmp_path / "b.tar", 3, "b")
    samples = list(NL.NativeTarSource(str(tmp_path / "*.tar"), n_threads=2, loop=False))
    assert len(samples) == 8
    keys = sorted(s["__key__"] for s in samples)
    assert keys[0].startswith("a") and keys[-1].startswith("b")
    assert samples[0]["txt"].startswith("caption") and samples[0]["json"] == {"a": 1}
    assert NL.LOADED_PATH == NL.library_path()


def test_native_reader_matches_python_reader(lib, tmp_path):
    _make_shard(tmp_path / "x.tar", 10)
    native = {s["__key__"]: s["txt"]
              for s in NL.NativeTarSource(str(tmp_path / "x.tar"), loop=False)}
    py_src = TarShardSource(str(tmp_path / "x.tar"), shuffle_buffer=1, resample=False,
                            native="never")
    python = {s["__key__"]: s["txt"] for s in itertools.islice(iter(py_src), 10)}
    assert native == python and len(native) == 10
    raw = list(NL.NativeTarSource(str(tmp_path / "x.tar"), loop=False, decode=False))
    assert raw[0]["txt"] == b"caption 0" and raw[0]["json"] == b'{"a": 1}'


def test_native_reader_loop_mode(lib, tmp_path):
    _make_shard(tmp_path / "l.tar", 2)
    src = NL.NativeTarSource(str(tmp_path / "l.tar"), loop=True)
    assert len(list(itertools.islice(iter(src), 7))) == 7   # cycles past the 2 samples


@pytest.mark.parametrize("fmt", [tarfile.GNU_FORMAT, tarfile.PAX_FORMAT], ids=["gnu", "pax"])
def test_native_reader_long_names(lib, tmp_path, fmt):
    """GNU 'L' and PAX 'x' long-name records are honoured: 100+-character
    member names would otherwise truncate and mis-group samples."""
    longkey = "d" * 120
    with tarfile.open(tmp_path / "long.tar", "w", format=fmt) as tf:
        for ext in ("txt", "json"):
            payload = b"x" if ext == "txt" else b'{"a": 2}'
            info = tarfile.TarInfo(f"{longkey}.{ext}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    samples = list(NL.NativeTarSource(str(tmp_path / "long.tar"), loop=False))
    assert len(samples) == 1
    assert samples[0]["__key__"] == longkey and samples[0]["json"] == {"a": 2}


def test_native_reader_corrupt_size_errors(lib, tmp_path):
    """A malformed size field surfaces as an error (rc -1), not as
    silently desynced samples."""
    _make_shard(tmp_path / "c.tar", 2)
    raw = bytearray((tmp_path / "c.tar").read_bytes())
    raw[124:136] = b"zzzzzzzzzzz\x00"
    (tmp_path / "c.tar").write_bytes(bytes(raw))
    with pytest.raises(RuntimeError):
        list(NL.NativeTarSource(str(tmp_path / "c.tar"), loop=False))


def test_native_reader_malformed_pax_record_errors(lib, tmp_path):
    """A PAX record whose declared length is smaller than its own "len "
    prefix surfaces as an error instead of underflowing the record-length
    arithmetic."""
    with tarfile.open(tmp_path / "p.tar", "w", format=tarfile.PAX_FORMAT) as tf:
        for ext in ("txt", "json"):
            payload = b"x" if ext == "txt" else b'{"a": 3}'
            info = tarfile.TarInfo(f"{'n' * 120}.{ext}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    raw = bytearray((tmp_path / "p.tar").read_bytes())
    offsets = [off for off in range(0, len(raw), 512) if raw[off + 156] == ord("x")]
    assert offsets, "no PAX header written"
    body = offsets[0] + 512
    sp = raw.index(b" ", body)
    raw[body:sp] = b"2".ljust(sp - body)             # declared len 2 < its 3-byte prefix
    (tmp_path / "p.tar").write_bytes(bytes(raw))
    with pytest.raises(RuntimeError):
        list(NL.NativeTarSource(str(tmp_path / "p.tar"), loop=False))


def test_tar_shard_source_falls_back_when_the_library_cannot_build(tmp_path, monkeypatch):
    _make_shard(tmp_path / "f.tar", 3)

    def no_compiler():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(NL, "_lib", None)
    monkeypatch.setattr(NL, "library_path", lambda: str(tmp_path / "absent.so"))
    monkeypatch.setattr(NL, "build", no_compiler)
    src = TarShardSource(str(tmp_path / "f.tar"), shuffle_buffer=1, resample=False)
    assert [s["txt"] for s in src] == ["caption 0", "caption 1", "caption 2"]
    assert src.reader == "python"
    always = TarShardSource(str(tmp_path / "f.tar"), resample=False, native="always")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        list(always)
