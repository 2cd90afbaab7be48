"""webdataset-style tar shard writer (a copy of
spider_tpu/datasets/shard_writer.py): stream (key, {ext: payload}) samples
into size-capped tar shards readable by both TarShardSource and the native
C++ reader."""

from __future__ import annotations

import io
import json
import tarfile
from typing import Any, Dict, Iterable, Optional


class ShardWriter:
    def __init__(self, pattern: str, max_samples: int = 10000):
        """pattern: e.g. '/data/shard-%05d.tar'."""
        self.pattern = pattern
        self.max_samples = max_samples
        self.shard_index = 0
        self.count = 0
        self._tar: Optional[tarfile.TarFile] = None
        self.paths = []

    def _ensure_open(self):
        if self._tar is None or self.count >= self.max_samples:
            if self._tar is not None:
                self._tar.close()
                self.shard_index += 1
                self.count = 0
            path = self.pattern % self.shard_index
            self._tar = tarfile.open(path, "w")
            self.paths.append(path)

    def write(self, key: str, sample: Dict[str, Any]) -> None:
        self._ensure_open()
        for ext, payload in sample.items():
            if isinstance(payload, bytes):
                data = payload
            elif isinstance(payload, str):
                data = payload.encode("utf-8")
            elif ext == "json" or isinstance(payload, (dict, list)):
                data = json.dumps(payload).encode("utf-8")
            elif hasattr(payload, "tobytes"):  # numpy: save as .npy
                import numpy as np

                buf = io.BytesIO()
                np.save(buf, payload)
                data = buf.getvalue()
                if not ext.endswith("npy"):
                    ext = ext + ".npy" if "." not in ext else ext
            else:
                raise TypeError(f"unsupported payload for .{ext}: "
                                f"{type(payload)}")
            info = tarfile.TarInfo(f"{key}.{ext}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self.count += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
