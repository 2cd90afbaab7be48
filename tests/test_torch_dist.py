"""spider_tpu_torch/common/dist.py, the logger's cross-rank sums and the
task's result shards against the JAX package.

``_factorize`` takes the JAX package's shapes and raises where it raises; a
4-rank gloo world (tests/torch_dist_ranks.py::basics) builds the
(data, fsdp, model, expert, context) mesh, refuses meshes the world cannot
hold, sums the logger's meters and merges save_result's shards on rank 0.
The data-parallel rank, which context peers share, is checked against the
mesh coordinates.
"""

import numpy as np
import pytest

from spider_tpu.common import dist as jdist
from spider_tpu_torch.common import dist
from torch_dist_ranks import run_world

SHAPES = [
    (8, [None, 1, 1, 1, 1]), (8, [2, 2, 2, 1, 1]), (8, [-1, 2, 1, 1, 2]),
    (4, [2, 1, 1, 1, 2]), (1, [1, 1, 1, 1, 1]), (1, [None, 1, 1, 1, 1]),
    (8, [3, None, 1, 1, 1]), (8, [None, None, 1, 1, 1]), (4, [2, 1, 1, 1, 4]),
    (1, [2, 1, 1, 1, 4]), (6, [4, 1, 1, 1, 1]), (12, [None, 2, 3, 1, 1]),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e).replace("devices", "ranks").replace("device count",
                                                                         "rank count"))


@pytest.mark.parametrize("n,shape", SHAPES, ids=[f"{n}-{s}" for n, s in SHAPES])
def test_factorize_equals_the_jax_one(n, shape):
    assert _outcome(dist._factorize, n, shape) == _outcome(jdist._factorize, n, shape)


def test_mesh_shape_names_the_world_it_cannot_hold():
    with pytest.raises(ValueError, match="rank count 1"):
        dist.mesh_shape(data=2, context=4, world_size=1)
    assert dist.mesh_shape(data=2, context=4, world_size=8) == (2, 1, 1, 1, 4)


def test_no_mesh_is_a_world_of_one_on_rank_zero():
    assert dist.data_parallel_rank(None) == (0, 1) and dist.context_rank(None) == (0, 1)
    assert dist.get_world_size() == 1 and dist.is_main_process()
    assert dist.main_process(lambda: 3)() == 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    return run_world("basics", 4, d / "world", result_dir=str(d / "results"))


def test_the_mesh_has_the_five_axes_over_the_gloo_world(world):
    for r, res in enumerate(world):
        assert res["backend"] == "gloo" and res["device_type"] == "cpu" and res["world"] == 4
        assert res["names"] == dist.AXES and res["shape"] == (2, 1, 1, 1, 2)
        # data outermost: rank = data * 2 + context
        assert list(res["coord"]) == [r // 2, 0, 0, 0, r % 2]


def test_context_peers_share_the_data_parallel_rank(world):
    assert [res["data_rank"] for res in world] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [res["context_rank"] for res in world] == [(0, 2), (1, 2), (0, 2), (1, 2)]


def test_a_mesh_the_world_cannot_hold_raises(world):
    want = [_outcome(jdist._factorize, 4, [d, f, 1, 1, c])[1] for d, f, c in
            ((8, 1, 1), (2, 1, 4), (3, 1, 1), (None, 3, 1), (None, 1, None))]
    for res in world:
        assert res["errors"] == want
        assert all(e is not None for e in res["errors"])


def test_synchronize_between_processes_sums_every_rank(world):
    # rank r logged r + 1 values 10 r + i
    count = sum(r + 1 for r in range(4))
    total = float(sum(10 * r + i for r in range(4) for i in range(r + 1)))
    for res in world:
        assert res["count"] == count and res["total"] == total


def test_save_result_merges_every_ranks_shard_on_rank_zero(world):
    import json

    path = world[0]["merged"]
    assert all(res["merged"] == path for res in world)
    with open(path) as f:
        merged = json.load(f)
    assert merged == [{"rank": r, "i": i} for r in range(4) for i in range(2)]


def test_save_result_of_one_process_matches_the_jax_task(tmp_path):
    import json

    from spider_tpu.tasks.base_task import BaseTask as JTask
    from spider_tpu_torch.tasks.base_task import BaseTask

    rows = [{"a": np.float64(1.5).item(), "b": "x"}]
    got = BaseTask().save_result(rows, str(tmp_path / "t"), "r")
    want = JTask().save_result(rows, str(tmp_path / "j"), "r")
    with open(got) as f, open(want) as g:
        assert json.load(f) == json.load(g)
