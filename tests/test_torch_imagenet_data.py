"""The port's real-image readers and dataset preparation
(``data/imagenet.py``, ``data/prepare.py``, ``data.make_dataset``)
against the JAX package's, twin of ``tests/test_imagenet_data.py`` and
``tests/test_prepare_ingest.py``, on a small JPEG tree written here (8
classes, 5 images each, 40-64 px on a side):

* ``ImageFolderDataset`` and ``NativeTFRecordImageNetDataset`` yield the
  JAX readers' batches BIT FOR BIT (images, labels, eval weights): train
  epochs 0 and 1, eval with exact coverage and a padded last batch, the
  2-process sharding, thread against spawned-process workers, and
  ``uint8`` against ``float32`` staging (and the device-side normalize
  within one pixel quantum of the float pipeline);
* the tf.data reader equals JAX's tf.data reader (eval bit for bit;
  train labels bit for bit, images shape and range: its crop and flip
  draw from TF's unseeded random ops);
* ``make_dataset``'s format resolution equals JAX's
  ``_resolve_data_format`` for every layout and format, with TensorFlow
  importable and with it hidden (``auto`` falls back to the native
  reader, a forced ``tfrecord`` raises ``ImportError``), and builds each
  reader;
* ``write_tfrecords`` and the mini-ILSVRC ``ingest`` (nested train tar,
  flat validation tar, a devkit with ``meta.mat``) give the JAX
  package's tree and byte-identical shards; the CLI runs.

Every test that imports TensorFlow is in this file (the import takes
seconds).
"""

import io
import os
import sys
import tarfile

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import imagenet as jax_imagenet
from distributeddeeplearning_tpu.data import prepare as jax_prepare
from distributeddeeplearning_tpu_torch.data import imagenet, prepare

CLASSES = [f"n0{i}000{i}" for i in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.RandomState(0)
    for cls in CLASSES:
        (root / cls).mkdir()
        for i in range(5):
            h, w = rng.randint(40, 65, size=2)
            arr = rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / cls / f"img_{i}.jpeg", quality=90)
    return str(root)


@pytest.fixture(scope="module")
def shards(image_tree, tmp_path_factory):
    """The tree as 3 TFRecord shards, written by each package."""
    out = tmp_path_factory.mktemp("shards")
    n, classes = prepare.write_tfrecords(image_tree, str(out / "port"), num_shards=3)
    jn, jclasses = jax_prepare.write_tfrecords(image_tree, str(out / "jax"), num_shards=3)
    assert (n, classes) == (jn, jclasses) == (40, CLASSES)
    return str(out / "port"), str(out / "jax")


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    return got


KW = dict(global_batch_size=8, image_size=24, num_workers=2)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_image_folder_matches_jax(image_tree, train):
    kw = dict(KW, train=train, global_batch_size=8 if train else 12)
    ds = imagenet.ImageFolderDataset(image_tree, **kw)
    ref = jax_imagenet.ImageFolderDataset(image_tree, **kw)
    assert (len(ds), ds.num_classes, ds.classes) == (40, 8, CLASSES)
    assert ds.steps_per_epoch == ref.steps_per_epoch == (5 if train else 4)
    for epoch in (0, 1):
        got = _same_batches(ds.epoch(epoch), ref.epoch(epoch))
    if train:
        assert got[0][0].shape == (8, 24, 24, 3) and got[0][0].dtype == np.float32
        assert not all(np.array_equal(a[1], b[1]) for a, b in zip(got, ds.epoch(0)))
    else:
        weights = np.concatenate([b[2] for b in got])
        assert weights.sum() == 40 and weights[-8:].sum() == 0  # 48 slots, 8 padded
        assert sorted(np.concatenate([b[1] for b in got])[weights > 0]) == sorted(
            [c for c in range(8) for _ in range(5)])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_two_process_sharding_matches_jax(image_tree, shards, train):
    port_dir, _ = shards
    seen = []
    for p in (0, 1):
        kw = dict(KW, train=train, process_index=p, process_count=2)
        _same_batches(imagenet.ImageFolderDataset(image_tree, **kw).epoch(1),
                      jax_imagenet.ImageFolderDataset(image_tree, **kw).epoch(1))
        got = _same_batches(
            imagenet.NativeTFRecordImageNetDataset(os.path.join(port_dir, "imagenet-*"),
                                                   **kw).epoch(1),
            jax_imagenet.NativeTFRecordImageNetDataset(os.path.join(port_dir, "imagenet-*"),
                                                       **kw).epoch(1))
        assert got[0][0].shape[0] == 4
        if not train:
            seen += [lb for b in got for lb in b[1][b[2] > 0]]
    if not train:
        assert len(seen) == 40  # every record on exactly one process


def test_process_workers_match_thread_workers_and_jax(image_tree, shards):
    """``worker_mode="process"`` (the reference's ``MULTIPROCESSING``):
    the port's spawned pool gives the JAX thread pool's batches, the
    pool is kept across epochs and ``close`` shuts it down."""
    kw = dict(KW, train=True)
    ds = imagenet.ImageFolderDataset(image_tree, worker_mode="process", **kw)
    try:
        _same_batches(ds.epoch(1), jax_imagenet.ImageFolderDataset(image_tree, **kw).epoch(1))
        pool = ds._pool
        assert pool is not None
        next(ds.epoch(2))
        assert ds._pool is pool
    finally:
        ds.close()
    assert ds._pool is None
    pattern = os.path.join(shards[0], "imagenet-*")
    nds = imagenet.NativeTFRecordImageNetDataset(pattern, worker_mode="process", **kw)
    try:
        _same_batches(nds.epoch(0),
                      jax_imagenet.NativeTFRecordImageNetDataset(pattern, **kw).epoch(0))
    finally:
        nds.close()
    with pytest.raises(ValueError, match="worker_mode"):
        next(imagenet.ImageFolderDataset(image_tree, worker_mode="fork", **kw).epoch(0))


def test_uint8_staging_matches_jax_and_the_float_pipeline(image_tree):
    from distributeddeeplearning_tpu_torch.data import normalize_staged_images

    kw = dict(KW, train=False)
    raw = _same_batches(
        imagenet.ImageFolderDataset(image_tree, image_dtype=np.uint8, **kw).epoch(0),
        jax_imagenet.ImageFolderDataset(image_tree, image_dtype=np.uint8, **kw).epoch(0))
    f32 = list(imagenet.ImageFolderDataset(image_tree, **kw).epoch(0))
    assert raw[0][0].dtype == np.uint8
    for (xr, yr, wr), (xf, yf, wf) in zip(raw, f32):
        np.testing.assert_array_equal(yr, yf)
        np.testing.assert_array_equal(wr, wf)
        got = normalize_staged_images(torch.from_numpy(xr)).numpy()
        np.testing.assert_allclose(got, xf, atol=1.5 / 255 / 0.22)


def test_native_tfrecord_reader_matches_jax(shards):
    """Each package's native reader over the other's shards: the same
    batches, train epochs 0 and 1 and exact eval, f32 and uint8."""
    port_dir, jax_dir = shards
    for train in (True, False):
        for dtype in (np.float32, np.uint8):
            kw = dict(KW, train=train, image_dtype=dtype)
            ds = imagenet.NativeTFRecordImageNetDataset(os.path.join(jax_dir, "imagenet-*"),
                                                        verify=True, **kw)
            ref = jax_imagenet.NativeTFRecordImageNetDataset(
                os.path.join(port_dir, "imagenet-*"), **kw)
            assert len(ds) == 40 and ds.steps_per_epoch == ref.steps_per_epoch
            for epoch in (0, 1) if train else (0,):
                got = _same_batches(ds.epoch(epoch), ref.epoch(epoch))
            assert got[0][0].dtype == dtype
            if not train:
                assert sum(float(b[2].sum()) for b in got) == 40.0


def test_tfdata_reader_matches_jax(shards):
    tf = pytest.importorskip("tensorflow")
    pattern = os.path.join(shards[0], "imagenet-*")
    kw = dict(global_batch_size=8, image_size=24)
    ds = imagenet.TFRecordImageNetDataset(pattern, train=False, **kw)
    ref = jax_imagenet.TFRecordImageNetDataset(pattern, train=False, **kw)
    assert ds.length == ref.length == 40  # from count.txt
    got = _same_batches(ds.epoch(0), ref.epoch(0))
    assert sum(float(b[2].sum()) for b in got) == 40.0
    ds = imagenet.TFRecordImageNetDataset(pattern, train=True, image_dtype=np.uint8, **kw)
    ref = jax_imagenet.TFRecordImageNetDataset(pattern, train=True, image_dtype=np.uint8, **kw)
    tf.random.set_seed(3)
    got = list(ds.epoch(1))
    tf.random.set_seed(3)
    want = list(ref.epoch(1))
    assert len(got) == len(want) == ds.steps_per_epoch == 5
    for (x, y), (rx, ry) in zip(got, want):
        np.testing.assert_array_equal(y, ry)
        assert x.shape == rx.shape == (8, 24, 24, 3) and x.dtype == rx.dtype == np.uint8


def _layouts(image_tree, shards, tmp_path):
    from distributeddeeplearning_tpu_torch.data.stream import synthetic_rows, write_token_shards

    stream = str(tmp_path / "stream")
    write_token_shards(stream, synthetic_rows(16, seq_len=4, vocab_size=8), seq_len=4,
                       vocab_size=8)
    single = tmp_path / "one.tfrecord"
    single.write_bytes(b"")
    return [image_tree, shards[0], os.path.join(shards[0], "imagenet-*"), stream,
            str(single), str(tmp_path / "data-00000-of-00004"), str(tmp_path / "plain")]


FORMATS = ["auto", "stream", "imagefolder", "tfrecord", "tfrecord-native", "parquet"]


@pytest.mark.parametrize("tf_present", [True, False], ids=["tf", "no-tf"])
def test_format_resolution_equals_jax(image_tree, shards, tmp_path, monkeypatch, tf_present):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data import _resolve_data_format as jax_resolve
    from distributeddeeplearning_tpu.data import _tfrecord_pattern as jax_pattern
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import _resolve_data_format, _tfrecord_pattern

    if tf_present:
        pytest.importorskip("tensorflow")
    else:
        monkeypatch.setitem(sys.modules, "tensorflow", None)  # import raises ImportError

    def outcome(resolve, cfg, root):
        try:
            return resolve(cfg, root)
        except (ValueError, ImportError) as e:
            return type(e).__name__

    for root in _layouts(image_tree, shards, tmp_path):
        assert _tfrecord_pattern(root) == jax_pattern(root), root
        for fmt in FORMATS:
            got = outcome(_resolve_data_format, TrainConfig(data_format=fmt), root)
            want = outcome(jax_resolve, JaxConfig(data_format=fmt), root)
            assert got == want, (root, fmt, got, want)
    assert _resolve_data_format(TrainConfig(), shards[0]) == (
        "tfrecord" if tf_present else "tfrecord-native")
    if not tf_present:
        with pytest.raises(ImportError, match="tfrecord-native"):
            _resolve_data_format(TrainConfig(data_format="tfrecord"), shards[0])


def test_make_dataset_builds_each_reader(image_tree, shards, tmp_path):
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset, make_dataset
    from distributeddeeplearning_tpu_torch.data.stream import RecordStreamDataset
    from distributeddeeplearning_tpu_torch.data.stream import synthetic_records
    from distributeddeeplearning_tpu_torch.data.stream import write_record_shards

    cfg = TrainConfig.from_env({"FAKE": "False", "DATA_DIR": shards[0],
                                "DATA_FORMAT": "tfrecord-native", "IMAGE_SIZE": "16",
                                "BATCHSIZE": "4", "NUM_WORKERS": "2",
                                "VAL_DATA_DIR": image_tree})
    ds = make_dataset(cfg, train=True)
    assert type(ds) is imagenet.NativeTFRecordImageNetDataset and len(ds) == 40
    assert ds.num_workers == 2 and ds.image_size == 16 and ds.train
    ev = make_dataset(cfg.replace(data_format="auto"), train=False)
    assert type(ev) is imagenet.ImageFolderDataset and not ev.train
    assert ev.seed == cfg.seed  # JAX's eval readers keep the seed
    assert type(make_dataset(cfg.replace(val_data_dir=None), train=False)) is \
        SyntheticImageDataset
    assert type(make_dataset(cfg.replace(fake=True), train=True)) is SyntheticImageDataset
    rec = str(tmp_path / "rec")
    write_record_shards(rec, synthetic_records(16, image_size=16, num_classes=8),
                        image_size=16, num_classes=8)
    sds = make_dataset(cfg.replace(data_dir=rec, data_format="auto",
                                   input_staging="uint8"), train=True)
    assert type(sds) is RecordStreamDataset and sds.image_dtype == np.uint8
    pytest.importorskip("tensorflow")
    tds = make_dataset(cfg.replace(data_format="tfrecord"), train=True)
    assert type(tds) is imagenet.TFRecordImageNetDataset and tds.length == 40


def test_write_tfrecords_bytes_equal_jax(shards, image_tree, tmp_path):
    port_dir, jax_dir = shards
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    assert names == ["classes.txt", "count.txt"] + [f"imagenet-{i:05d}-of-00003"
                                                   for i in range(3)]
    for name in names:
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    n, _ = prepare.write_tfrecords(image_tree, str(tmp_path / "lim"), num_shards=2,
                                   prefix="val", limit=5)
    assert n == 5 and sorted(os.listdir(tmp_path / "lim"))[-1] == "val-00001-of-00002"


# ---------------------------------------------------------------------------
# The mini-ILSVRC distribution: nested train tar, flat val tar, devkit
# ---------------------------------------------------------------------------

WNIDS = ("n01440764", "n01443537", "n01484850")
VAL_IDS = [3, 1, 2, 1, 3, 2]


def _jpeg_bytes(rng) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, size=(24, 24, 3), dtype=np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _add_bytes(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def mini_ilsvrc(tmp_path_factory):
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("ilsvrc")
    rng = np.random.RandomState(0)
    train_tar = root / "ILSVRC2012_img_train.tar"
    with tarfile.open(train_tar, "w") as outer:
        for wnid in WNIDS:
            inner = io.BytesIO()
            with tarfile.open(fileobj=inner, mode="w") as class_tar:
                for i in range(4):
                    _add_bytes(class_tar, f"{wnid}_{i}.JPEG", _jpeg_bytes(rng))
            _add_bytes(outer, f"{wnid}.tar", inner.getvalue())
    val_tar = root / "ILSVRC2012_img_val.tar"
    with tarfile.open(val_tar, "w") as tar:
        for i in range(len(VAL_IDS)):
            _add_bytes(tar, f"ILSVRC2012_val_{i + 1:08d}.JPEG", _jpeg_bytes(rng))
    synsets = np.zeros((4, 1), dtype=[("ILSVRC2012_ID", "O"), ("WNID", "O"),
                                      ("words", "O"), ("num_children", "O")])
    rows = [(1, WNIDS[1], "fish a", 0), (2, WNIDS[0], "fish b", 0),
            (3, WNIDS[2], "shark", 0), (4, "n99999999", "animal (parent)", 2)]
    for i, (ilsvrc_id, wnid, words, children) in enumerate(rows):
        synsets[i, 0] = (np.array([[ilsvrc_id]]), np.array([wnid]), np.array([words]),
                         np.array([[children]]))
    meta = io.BytesIO()
    savemat(meta, {"synsets": synsets})
    devkit = root / "ILSVRC2012_devkit_t12.tar.gz"
    with tarfile.open(devkit, "w:gz") as tar:
        _add_bytes(tar, "ILSVRC2012_devkit_t12/data/meta.mat", meta.getvalue())
        _add_bytes(tar, "ILSVRC2012_devkit_t12/data/ILSVRC2012_validation_ground_truth.txt",
                   "".join(f"{i}\n" for i in VAL_IDS).encode())
    return str(train_tar), str(val_tar), str(devkit)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_ingest_gives_jax_tree_and_shards(mini_ilsvrc, tmp_path):
    mapping = prepare.devkit_val_mapping(mini_ilsvrc[2])
    assert mapping == jax_prepare.devkit_val_mapping(mini_ilsvrc[2])
    assert mapping[0] == ("ILSVRC2012_val_00000001.JPEG", WNIDS[2])
    got = prepare.ingest(*mini_ilsvrc, str(tmp_path / "port"), num_shards=2, val_shards=1)
    want = jax_prepare.ingest(*mini_ilsvrc, str(tmp_path / "jax"), num_shards=2, val_shards=1)
    assert got == want
    assert got["train_images"] == got["train_tfrecords"] == 12
    assert got["val_sorted"] == got["val_tfrecords"] == len(VAL_IDS)
    tree, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert tree.keys() == ref.keys()
    for k in tree:
        assert tree[k] == ref[k], k
    assert "tfrecords/train/imagenet-00001-of-00002" in tree
    assert not (tmp_path / "port" / "_val_flat").exists()
    ds = imagenet.NativeTFRecordImageNetDataset(
        str(tmp_path / "port" / "tfrecords" / "train" / "imagenet-*"),
        global_batch_size=4, image_size=16, train=True, num_workers=2)
    images, labels = next(ds.epoch(0))
    assert images.shape == (4, 16, 16, 3) and labels.max() < 3


def test_prepare_cli(mini_ilsvrc, image_tree, tmp_path, capsys):
    train_tar, val_tar, devkit = mini_ilsvrc
    assert prepare.main(["ingest", "--train-tar", train_tar, "--val-tar", val_tar,
                         "--devkit", devkit, "--out", str(tmp_path / "o"),
                         "--no-tfrecords"]) == 0
    assert "train_images=12" in capsys.readouterr().out
    assert not (tmp_path / "o" / "tfrecords").exists()
    assert prepare.main(["tfrecords", "--src", image_tree, "--out", str(tmp_path / "t"),
                         "--num-shards", "2"]) == 0
    assert "wrote 40 images, 8 classes" in capsys.readouterr().out
    from PIL import Image

    val = tmp_path / "val"
    val.mkdir()
    for i in range(3):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(val / f"v{i}.JPEG")
    (tmp_path / "map.txt").write_text("v0.JPEG n01\nv1.JPEG n02\nv2.JPEG n02\nv9.JPEG n03\n")
    assert prepare.main(["valprep", "--val-dir", str(val), "--mapping",
                         str(tmp_path / "map.txt"), "--out", str(tmp_path / "s")]) == 0
    assert "moved 3 images" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "s")) == ["n01", "n02"]
