"""The port's dataset builders, data sources and loaders against the JAX
package on the CPU.

Every builder of the JAX package is registered in the port, and for the same
``build_info`` and seed gives the same samples: arrays exactly (values and
dtypes), strings equal. Sources: the synthetic twins, a REFER corpus
(polygon and compressed-RLE annotations, a png image), an ``ann_path`` JSON,
an HDF5 story file, a travel JSON and webdataset tar shards (png, txt, flac,
wav and pre-decoded ``jpg.npy`` members) written by the port's
``ShardWriter``. These modules are numpy-only in both packages: nothing here
compiles JAX.
"""

import io
import itertools
import json
import os
import pickle
import threading

import numpy as np
import pytest
import torch

import spider_tpu.datasets  # noqa: F401  (registers the JAX builders)
import spider_tpu_torch.datasets  # noqa: F401  (registers the port's)
from spider_tpu.common.registry import registry as jreg
from spider_tpu.datasets import backends as jB
from spider_tpu.datasets.utils import loaders as jL
from spider_tpu_torch.common.registry import registry as treg
from spider_tpu_torch.datasets import backends as tB
from spider_tpu_torch.datasets.utils import loaders as tL

ALL_BUILDERS = [
    "i2t_cc_sbu", "v2t_webvid", "a2t_audiocap",
    "t2i_cc_sbu", "t2v_webvid", "t2a_audiocap",
    "t2i_ts_cc_sbu", "t2v_ts_webvid", "t2a_ts_audiocap",
    "t2v_ts_mul_webvid", "t2v_ts_spec_webvid",
    "i2t_ts_cc_sbu", "v2t_ts_webvid", "a2t_ts_audiocap",
    "it2b_refcoco", "it2m_refcoco", "it2b_ts_refcoco", "it2m_ts_refcoco",
    "travel_guide", "pororo", "flintstones",
]
GROUNDING = ["it2b_refcoco", "it2m_refcoco", "it2b_ts_refcoco", "it2m_ts_refcoco"]
TINY_INFO = dict(synthetic_size=32, num_samples=4, image_size=28, num_clips=2,
                 num_mels=16, target_length=20, sam_size=64, seed=3)


def assert_same(a, b, where="sample"):
    """Nested dicts, lists and tuples equal: arrays exactly, with their
    dtypes; every other leaf by ==."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in b:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (where, a, b)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _samples(ds, n):
    return list(itertools.islice(iter(ds), n))


def _both(name, build_info, n=2):
    cfg = dict(build_info=dict(build_info))
    tds = treg.get_builder_class(name)(cfg).build_datasets()
    jds = jreg.get_builder_class(name)(cfg).build_datasets()
    return _samples(tds, n), _samples(jds, n)


# ---------------------------------------------------------------------------
# registry and the synthetic twins
# ---------------------------------------------------------------------------

def test_all_21_builders_registered():
    assert sorted(ALL_BUILDERS) == jreg.list_builders()
    assert treg.list_builders() == jreg.list_builders()


@pytest.mark.parametrize("name", ALL_BUILDERS)
def test_builder_samples_equal_the_jax_builders(name):
    t, j = _both(name, TINY_INFO)
    assert len(t) == 2
    assert_same(t, j, name)


# ---------------------------------------------------------------------------
# files: REFER corpus, ann_path JSON, HDF5 story, travel JSON
# ---------------------------------------------------------------------------

def _coco_rle(mask: np.ndarray) -> str:
    """A mask's compressed COCO RLE string (column-major runs, delta-coded
    from the run before last, 5-bit groups)."""
    flat = mask.T.reshape(-1)
    runs, val, count = [], 0, 0
    for v in flat:
        if v == val:
            count += 1
        else:
            runs.append(count)
            val, count = v, 1
    runs.append(count)
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = 1
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10) or x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def write_refer(root, seed=0):
    """refcoco/refs(unc).p and instances.json with a polygon and a
    compressed-RLE annotation, and one png image under root/images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "refcoco"))
    os.makedirs(os.path.join(root, "images"))
    Image.fromarray(rng.integers(0, 256, (40, 56, 3), np.uint8)).save(
        os.path.join(root, "images", "img7.png"))
    rle_mask = np.zeros((40, 56), np.uint8)
    rle_mask[5:20, 30:50] = 1
    rle_mask[22:30, 10:14] = 1
    refs = [dict(ref_id=1, ann_id=10, image_id=7, split="train",
                 sentences=[dict(sent="the red box"), dict(sent="left thing")]),
            dict(ref_id=2, ann_id=11, image_id=7, split="train",
                 sentences=[dict(sent="two blocks")]),
            dict(ref_id=3, ann_id=11, image_id=7, split="val",
                 sentences=[dict(sent="held out")])]
    instances = dict(
        images=[dict(id=7, file_name="img7.png", height=40, width=56)],
        annotations=[
            dict(id=10, image_id=7, bbox=[3.5, 6.0, 21.0, 12.5],
                 segmentation=[[3.5, 6.0, 24.5, 6.0, 24.5, 18.5, 3.5, 18.5],
                               [30.2, 25.1, 40.7, 25.1, 35.0, 36.9]]),
            dict(id=11, image_id=7, bbox=[10.0, 5.0, 40.0, 25.0],
                 segmentation=dict(counts=_coco_rle(rle_mask), size=[40, 56]))],
        categories=[dict(id=1, name="box")])
    with open(os.path.join(root, "refcoco", "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(root, "refcoco", "instances.json"), "w") as f:
        json.dump(instances, f)
    return rle_mask


@pytest.mark.parametrize("name", GROUNDING)
def test_grounding_builders_from_a_refer_corpus(name, tmp_path):
    write_refer(str(tmp_path))
    info = dict(refer_root=str(tmp_path), image_path=str(tmp_path / "images"), sam_size=64)
    t, j = _both(name, info, n=3)
    assert_same(t, j, name)
    assert [s["Caption"] for s in t] == ["the red box", "left thing", "two blocks"]
    assert t[0]["Image_ori_array"].any()          # the png was read, not a blank canvas


def test_refer_masks_equal_bit_for_bit(tmp_path):
    from spider_tpu.datasets import refer as jR
    from spider_tpu_torch.datasets import refer as tR

    rle_mask = write_refer(str(tmp_path))
    tc = tR.ReferCorpus(str(tmp_path), str(tmp_path / "images"))
    jc = jR.ReferCorpus(str(tmp_path), str(tmp_path / "images"))
    for ref in tc.refs:
        assert_same(tc.get_mask(ref), jc.get_mask(ref))
    np.testing.assert_array_equal(tc.get_mask(tc.load_ref(2)), rle_mask)
    assert_same(list(tc.records(None)), list(jc.records(None)))
    src, jsrc = tR.ReferRecordSource(tc, "val"), jR.ReferRecordSource(jc, "val")
    assert len(src) == len(jsrc) == 1
    assert_same(src[0], jsrc[0])
    # the numpy scanline fill and the compressed RLE decoder on their own
    rng = np.random.default_rng(1)
    polys = [list(rng.uniform(0, 30, 12)), list(rng.uniform(5, 25, 8)), [1.0, 2.0, 3.0, 4.0]]
    assert_same(tR._scanline_fill(polys, 31, 27), jR._scanline_fill(polys, 31, 27))
    assert_same(tR.polygons_to_mask(polys, 31, 27), jR.polygons_to_mask(polys, 31, 27))
    mask = (rng.random((13, 9)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(tR.decode_compressed_rle(_coco_rle(mask), 13, 9), mask)
    ann = dict(segmentation=dict(counts=[3, 5, 100], size=[12, 9]))
    assert_same(tR.ann_to_mask(ann, 12, 9), jR.ann_to_mask(ann, 12, 9))
    assert_same(tR.ann_to_mask({}, 4, 5), jR.ann_to_mask({}, 4, 5))


@pytest.mark.parametrize("name", ["it2b_refcoco", "it2m_ts_refcoco"])
def test_grounding_builders_from_an_ann_path_json(name, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    anns = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (30 + i, 44, 3), np.uint8)).save(
            tmp_path / f"a{i}.png")
        ann = dict(image=f"a{i}.png", bbox=[2.0 + i, 3.0, 10.0, 12.0],
                   sentences=["a cat", "the cat on the left"] if i != 1 else "one dog")
        if i == 2:
            ann["mask"] = (rng.random((32, 44)) > 0.5).astype(int).tolist()
        anns.append(ann)
    (tmp_path / "anns.json").write_text(json.dumps(anns))
    info = dict(ann_path=str(tmp_path / "anns.json"), image_path=str(tmp_path), sam_size=64)
    cfg = dict(build_info=info)
    tds = treg.get_builder_class(name)(cfg).build_datasets()
    jds = jreg.get_builder_class(name)(cfg).build_datasets()
    for i in range(3):
        # _RealRefer draws the sentence from numpy's global generator
        np.random.seed(i)
        t = tds[i]
        np.random.seed(i)
        assert_same(t, jds[i], f"{name}[{i}]")


@pytest.mark.parametrize("name", ["pororo", "flintstones"])
def test_story_builders_from_an_hdf5_file(name, tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(4)
    path = str(tmp_path / "story.h5")
    with h5py.File(path, "w") as f:
        f["image"] = rng.integers(0, 256, (3, 5, 24, 32, 3), np.uint8)
        f["text"] = np.array([[f"scene {s}.{i} happens" for i in range(5)] for s in range(3)],
                             dtype="S")
    t, j = _both(name, dict(hdf5_path=path, seed=5), n=3)
    assert_same(t, j, name)
    assert t[2]["texts"][4] == "scene 2 4 happens"      # text_processor drops the dot


def test_travel_guide_from_a_json_file(tmp_path):
    guides = [dict(location=f"City {i}", answer_multimodal=dict(
        introduction=f"City {i} is old.",
        must_see_attractions=[f"Gate {i}<IMAGE>the gate {i}</IMAGE>: stone."],
        food=f"Soup<IMAGE>soup {i}</IMAGE>: hot.")) for i in range(4)]
    (tmp_path / "guides.json").write_text(json.dumps(guides))
    t, j = _both("travel_guide", dict(json_path=str(tmp_path / "guides.json"), seed=2), n=4)
    assert_same(t, j)
    assert t[3]["Location"] == "City 3"


# ---------------------------------------------------------------------------
# tar shards: the port reads real shards (png, txt, flac, wav, jpg.npy)
# ---------------------------------------------------------------------------

def write_shards(directory, n=5, per_shard=3, seed=0, writer="port"):
    """Tar shards of `n` samples, each a png image, a caption, the same
    0.5 s tone as flac and as wav, and the image again as jpg.npy; written
    by the port's ShardWriter and encoders, or by the JAX package's."""
    from PIL import Image

    if writer == "port":
        from spider_tpu_torch.datasets import media
        from spider_tpu_torch.datasets.flac import encode_flac
        from spider_tpu_torch.datasets.shard_writer import ShardWriter
    else:
        from spider_tpu.datasets import media
        from spider_tpu.datasets.flac import encode_flac
        from spider_tpu.datasets.shard_writer import ShardWriter
    rng = np.random.default_rng(seed)
    with ShardWriter(os.path.join(directory, "shard-%03d.tar"), max_samples=per_shard) as w:
        for i in range(n):
            img = rng.integers(0, 256, (20 + i, 24, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "PNG")
            t = np.arange(4000) / 8000
            wave = (0.4 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32)
            w.write(f"s{i:04d}", {"png": buf.getvalue(), "txt": f"a caption {i}",
                                  "flac": encode_flac(wave, 8000),
                                  "wav": media.encode_wav_bytes(wave, 8000), "jpg": img})
    return w.paths


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("native", ["auto", "never"])
def test_real_shards_read_as_the_jax_reader_reads_them(native, writer, tmp_path):
    """The port's reader on real shards (the JAX writer's: the reader alone;
    the port's: its ShardWriter round trip)."""
    paths = write_shards(str(tmp_path), writer=writer)
    assert [os.path.basename(p) for p in paths] == ["shard-000.tar", "shard-001.tar"]
    pattern = str(tmp_path / "shard-*.tar")
    src = tB.TarShardSource(pattern, shuffle_buffer=1, resample=False, native=native)
    got = list(src)
    want = list(jB.TarShardSource(pattern, shuffle_buffer=1, resample=False, native="never"))
    assert src.reader == ("native" if native == "auto" else "python")
    assert len(got) == len(want) == 5
    if native == "auto":     # native threads interleave the shards: compare by key
        got = sorted(got, key=lambda s: s["__key__"])
        want = sorted(want, key=lambda s: s["__key__"])
    assert_same(got, want)
    s = got[0]
    assert set(s) == {"__key__", "png", "txt", "flac", "wav", "jpg", "sample_rate"}
    np.testing.assert_array_equal(s["png"], s["jpg"])
    assert s["flac"].dtype == np.float32 and s["sample_rate"] == 8000


@pytest.mark.parametrize("name", ["i2t_cc_sbu", "t2a_ts_audiocap"])
def test_builders_from_tar_shards_equal_the_jax_builders(name, tmp_path):
    write_shards(str(tmp_path), n=4, per_shard=4)
    info = dict(webdataset_path=str(tmp_path / "shard-*.tar"), shuffle_buffer=2, seed=1,
                image_size=28, num_mels=16, target_length=20)
    cfg = dict(build_info=info)
    tds = treg.get_builder_class(name)(cfg).build_datasets()
    jds = jreg.get_builder_class(name)(cfg).build_datasets()
    tds.source.native = jds.source.native = "never"      # one shard order for both
    assert_same(_samples(tds, 5), _samples(jds, 5), name)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

class _Epochs:
    def __init__(self, n):
        self.n, self.epochs = n, []

    def set_epoch(self, e):
        self.epochs.append(e)

    def __iter__(self):
        return iter(range(self.n))


def test_iter_loader_restarts_and_counts_epochs():
    src = _Epochs(3)
    it = tL.IterLoader(src)
    jit = jL.IterLoader(_Epochs(3))
    assert [next(it) for _ in range(8)] == [next(jit) for _ in range(8)] \
        == [0, 1, 2, 0, 1, 2, 0, 1]
    assert it.epoch == jit.epoch == 2 and src.epochs == [1, 2]


def test_chain_dataset_draws_in_the_jax_order():
    def sources():
        return [itertools.count(100 * i) for i in range(3)]

    t = tL.ChainDataset(sources(), [1.0, 2.0, 0.5], seed=4)
    j = jL.ChainDataset(sources(), [1.0, 2.0, 0.5], seed=4)
    assert list(itertools.islice(iter(t), 40)) == list(itertools.islice(iter(j), 40))


def _batches(n=4, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        ro = rng.standard_normal((3, 5)).astype(np.float32)
        ro.flags.writeable = False
        yield {"Question": [f"q{i}", "r"], "IMAGE": [rng.standard_normal((2, 4)), ro],
               "MASK": (rng.random((6, 6)) > 0.5), "ids": np.arange(i, i + 3)[::-1],
               "Meta_info": {"shape": [(3, 4)], "box": [np.ones(4, np.float32)]},
               "obj": np.array([None, "x"], dtype=object)}


def _assert_tensors_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tensors_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for x, y in zip(got, want):
            _assert_tensors_equal(x, y)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    elif isinstance(want, np.ndarray):                  # object arrays stay numpy
        assert isinstance(got, np.ndarray) and got.tolist() == want.tolist()
    else:
        assert got == want


def test_prepare_sample_moves_numpy_leaves_to_tensors_on_the_device():
    batch = next(_batches())
    out = tL.prepare_sample(batch, "cpu")
    assert out["Question"] == ["q0", "r"]
    assert isinstance(out["IMAGE"][1], torch.Tensor) and out["IMAGE"][1].dtype == torch.float32
    assert out["IMAGE"][0].dtype == torch.float64 and out["MASK"].dtype == torch.bool
    np.testing.assert_array_equal(out["ids"].numpy(), [2, 1, 0])
    assert out["Meta_info"]["shape"] == [(3, 4)] and isinstance(out["Meta_info"]["shape"][0], tuple)
    assert out["obj"] is batch["obj"]                    # object arrays are not data
    # the values the JAX prepare_sample puts on its device
    jout = jL.prepare_sample(batch, None)
    np.testing.assert_array_equal(out["IMAGE"][1].numpy(), np.asarray(jout["IMAGE"][1]))
    np.testing.assert_array_equal(out["MASK"].numpy(), np.asarray(jout["MASK"]))


def test_prefetch_loader_on_the_cpu_equals_prepare_sample():
    got = list(tL.PrefetchLoader(_batches(6), 2, "cpu"))
    want = [tL.prepare_sample(b, "cpu") for b in _batches(6)]
    assert len(got) == 6
    _assert_tensors_equal(got, want)


def test_prefetch_loader_raises_the_loaders_error_and_stops_its_worker():
    def failing():
        yield from _batches(2)
        raise OSError("shard gone")

    it = iter(tL.PrefetchLoader(failing(), 1, "cpu"))
    next(it), next(it)
    with pytest.raises(OSError, match="shard gone"):
        next(it)
    before = threading.active_count()
    it = iter(tL.PrefetchLoader(itertools.repeat({"x": np.zeros(3)}), 2, "cpu"))
    next(it)
    it.close()                                           # the consumer stops early
    assert threading.active_count() <= before
