"""Nothing in benchmark/ imports JAX or the JAX package, and the reference
imports nothing of the program; top-level module names are compared whole
(spider_tpu_torch begins with spider_tpu but is not it)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "spider_tpu"}


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def _files(sub=""):
    return sorted(glob.glob(os.path.join(cells.BENCH_DIR, sub, "**", "*.py"), recursive=True))


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = _files()
    assert len(files) > 20
    for path in files:
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    files = _files("reference")
    assert files
    for path in files:
        names = _top_level_imports(path)
        assert names <= {"__future__", "math", "typing", "torch", "benchmark"}, (path, names)
        with open(path) as f:
            text = f.read()
        assert "spider_tpu_torch" not in text, path


def test_the_whole_name_check_of_the_run():
    from benchmark import run

    before = dict(sys.modules)
    try:
        sys.modules["spider_tpu_torch_probe"] = sys
        sys.modules["spider_tpux"] = sys
        assert run.forbidden_modules() == sorted(
            {n.split(".", 1)[0] for n in before} & FORBIDDEN)
        sys.modules["spider_tpu.models"] = sys
        assert "spider_tpu" in run.forbidden_modules()
    finally:
        for name in ("spider_tpu_torch_probe", "spider_tpux", "spider_tpu.models"):
            sys.modules.pop(name, None)


def _run(cwd, timeout=300):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sd15.image",
                           "--seed", "3000000007", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_without_a_card_the_run_exits_without_a_result():
    proc = _run(cells.ROOT)
    if proc.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert proc.returncode == 2 and not proc.stdout.strip()


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "build_cache"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()
