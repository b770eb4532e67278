"""The port's streamed data plane (``data/stream/``, ``streamgen``)
against the JAX package's, twin of ``tests/test_stream.py``:

* shard sets written by either package's writers are byte-identical
  (shard files and ``stream_index.json``) and each package reads the
  other's; index gathers, corruption errors naming the file;
* the block shuffle is a permutation equal to JAX's for every block
  size, and its seek equals the slice;
* ``epoch_at(e, k)`` is bitwise the replayed stream's tail, and every
  batch equals the JAX dataset's (token and record streams, uint8 and
  float32 staging);
* the global batch is process-count independent, and a mid-epoch cursor
  written at one process re-enters at 2 and 4 processes bitwise; the
  cursor dict equals JAX's;
* ``host_prefetch`` is math-neutral, adds no host sync, emits the
  ``data.*`` gauges through the port's bus, stops when abandoned and
  passes reader errors on;
* ``STREAM_SHUFFLE_BLOCK``, ``PREFETCH_HOST_BATCHES``, ``DATA_FORMAT``,
  the data directories, ``NUM_WORKERS`` and ``WORKER_MODE`` /
  ``MULTIPROCESSING`` parse as JAX's ``TrainConfig.from_env`` does, and
  ``resolve_engine`` refuses what JAX's refuses;
* the ``streamgen`` CLI round trip, its files equal to
  ``scripts/streamgen.py``'s.
"""

import json
import os

import numpy as np
import pytest

from distributeddeeplearning_tpu.data import stream as jax_stream
from distributeddeeplearning_tpu_torch.data.stream import (
    INDEX_BASENAME,
    BlockShuffle,
    RecordStreamDataset,
    StreamFormatError,
    TokenStreamDataset,
    corpus_to_rows,
    host_prefetch,
    load_index,
    open_stream_dataset,
    synthetic_records,
    synthetic_rows,
    write_record_shards,
    write_token_shards,
)

VOCAB, T = 64, 8


def _token_dir(tmp_path, n=64, shard=16, seed=7, writer=write_token_shards, name="tok"):
    d = str(tmp_path / f"{name}{n}")
    if not os.path.isdir(d):
        writer(d, synthetic_rows(n, seq_len=T, vocab_size=VOCAB, seed=seed), seq_len=T,
               vocab_size=VOCAB, shard_records=shard)
    return d


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Shards and index
# ---------------------------------------------------------------------------

def test_shard_sets_byte_identical_to_jax_and_cross_readable(tmp_path):
    ours = _token_dir(tmp_path, n=50, name="port")
    theirs = _token_dir(tmp_path, n=50, writer=jax_stream.write_token_shards, name="jax")
    assert _files(ours) == _files(theirs)
    im, lb = synthetic_records(37, image_size=5, num_classes=3, seed=2)
    np.testing.assert_array_equal(im, jax_stream.synthetic_records(
        37, image_size=5, num_classes=3, seed=2)[0])
    rec_ours, rec_theirs = str(tmp_path / "rp"), str(tmp_path / "rj")
    meta = write_record_shards(rec_ours, (im, lb), image_size=5, num_classes=3,
                               shard_records=16)
    assert meta == jax_stream.write_record_shards(rec_theirs, (im, lb), image_size=5,
                                                  num_classes=3, shard_records=16)
    assert _files(rec_ours) == _files(rec_theirs)
    assert json.loads(_files(rec_ours)[INDEX_BASENAME]) == meta
    ids = np.array([36, 0, 17, 17, 33, 2])
    for field in ("image", "label"):
        np.testing.assert_array_equal(load_index(rec_theirs).read(field, ids),
                                      jax_stream.load_index(rec_ours).read(field, ids))
    idx = load_index(theirs)
    assert (idx.total_records, len(idx.shards), idx.nbytes) == (50, 4, 50 * (T + 1) * 4)
    rows = synthetic_rows(50, seq_len=T, vocab_size=VOCAB, seed=7)
    np.testing.assert_array_equal(idx.read("tokens", np.arange(50)), rows)
    np.testing.assert_array_equal(idx.read("tokens", ids), rows[ids])
    with pytest.raises(IndexError):
        idx.read("tokens", np.array([50]))


def test_corruption_is_a_clear_error(tmp_path):
    d = _token_dir(tmp_path)
    victim = os.path.join(d, "shard-00001.tokens.bin")
    with open(victim, "r+b") as f:
        f.truncate(10)
    with pytest.raises(StreamFormatError, match="shard-00001.tokens.bin"):
        load_index(d)
    os.remove(victim)
    with pytest.raises(StreamFormatError, match="missing"):
        load_index(d)
    d2 = str(tmp_path / "bad")
    os.makedirs(d2)
    with open(os.path.join(d2, INDEX_BASENAME), "w") as f:
        f.write("{not json")
    with pytest.raises(StreamFormatError, match="unreadable"):
        load_index(d2)
    with pytest.raises(StreamFormatError, match="no stream index"):
        load_index(str(tmp_path / "nowhere"))
    d3 = str(tmp_path / "rec")
    write_record_shards(d3, synthetic_records(8, image_size=4, num_classes=2, seed=1),
                        image_size=4, num_classes=2, shard_records=4)
    with pytest.raises(StreamFormatError, match="not a token stream"):
        TokenStreamDataset(d3, global_batch_size=4)
    with pytest.raises(ValueError, match="8 records < global batch 16"):
        RecordStreamDataset(d3, global_batch_size=16)


# ---------------------------------------------------------------------------
# Shuffle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 7, 16, 64, 1000])
def test_block_shuffle_is_jax_permutation(block):
    sh = BlockShuffle(64, seed=11, block_size=block)
    ref = jax_stream.BlockShuffle(64, seed=11, block_size=block)
    seen = []
    for epoch in (0, 1, 2):
        p = sh.epoch_order(epoch).positions(0, 64)
        np.testing.assert_array_equal(p, ref.epoch_order(epoch).positions(0, 64))
        assert sorted(p) == list(range(64))
        seen.append(tuple(p))
    if block < 64:
        assert len(set(seen)) == 3
    full = sh.epoch_order(3).positions(0, 64)
    for start, stop in ((0, 64), (20, 50), (63, 64), (10, 10)):
        np.testing.assert_array_equal(sh.epoch_order(3).positions(start, stop),
                                      full[start:stop])
    with pytest.raises(IndexError):
        sh.epoch_order(0).positions(10, 65)


# ---------------------------------------------------------------------------
# Datasets: seek == replay == JAX, process-count independence
# ---------------------------------------------------------------------------

def test_epoch_at_matches_replay_and_jax(tmp_path):
    d = _token_dir(tmp_path)
    ds = TokenStreamDataset(d, global_batch_size=16, seed=5, shuffle_block=16)
    ref = jax_stream.TokenStreamDataset(d, global_batch_size=16, seed=5, shuffle_block=16)
    assert ds.steps_per_epoch == 4 and ds.seq_len == T and ds.vocab_size == VOCAB
    for epoch in (0, 2):
        full = list(ds.epoch(epoch))
        _same(full, ref.epoch(epoch))
        for k in (0, 1, 3, 4):
            tail = list(ds.epoch_at(epoch, k))
            assert len(tail) == len(full) - k
            if tail:
                _same(tail, full[k:])
                _same(tail, ref.epoch_at(epoch, k))
    with pytest.raises(IndexError):
        next(ds.epoch_at(0, 5))


def test_record_stream_matches_jax(tmp_path):
    d = str(tmp_path / "rec")
    write_record_shards(d, synthetic_records(48, image_size=4, num_classes=8, seed=3),
                        image_size=4, num_classes=8, shard_records=16)
    for dtype in (np.uint8, np.float32):
        for one_hot in (False, True):
            kw = dict(global_batch_size=8, seed=4, image_dtype=dtype, one_hot=one_hot)
            ds = RecordStreamDataset(d, **kw)
            _same(ds.epoch(1), jax_stream.RecordStreamDataset(d, **kw).epoch(1))
    fx, _ = next(iter(RecordStreamDataset(d, global_batch_size=8, seed=4).epoch(0)))
    assert fx.dtype == np.float32 and fx.min() < 0  # normalized on the host
    assert type(open_stream_dataset(d, global_batch_size=8, image_dtype=np.uint8)) is \
        RecordStreamDataset


@pytest.mark.parametrize("kind", ["tokens", "records"])
def test_global_batch_is_process_count_independent(tmp_path, kind):
    if kind == "tokens":
        d = _token_dir(tmp_path)

        def make(**kw):
            return TokenStreamDataset(d, global_batch_size=16, seed=9, shuffle_block=8, **kw)
    else:
        d = str(tmp_path / "rec")
        write_record_shards(d, synthetic_records(48, image_size=4, num_classes=8, seed=3),
                            image_size=4, num_classes=8, shard_records=16)

        def make(**kw):
            return RecordStreamDataset(d, global_batch_size=16, seed=9, shuffle_block=8,
                                       image_dtype=np.uint8, **kw)
    full = list(make().epoch(1))
    for pc in (2, 4):
        iters = [make(process_index=i, process_count=pc).epoch(1) for i in range(pc)]
        for x, y in full:
            xs, ys = zip(*[next(it) for it in iters])
            np.testing.assert_array_equal(np.concatenate(xs), x)
            np.testing.assert_array_equal(np.concatenate(ys), y)


def test_cursor_continues_bitwise_across_process_counts(tmp_path):
    d = _token_dir(tmp_path)
    one = TokenStreamDataset(d, global_batch_size=16, seed=13, shuffle_block=16)
    full = list(one.epoch(0))
    cur = one.cursor(0, 2)
    assert cur == jax_stream.TokenStreamDataset(
        d, global_batch_size=16, seed=13, shuffle_block=16).cursor(0, 2)
    assert (cur["epoch"], cur["offset"], cur["records"], cur["kind"]) == (0, 2, 64, "tokens")
    for pc in (2, 4):
        shards = [TokenStreamDataset(d, global_batch_size=16, seed=cur["seed"],
                                     shuffle_block=16, process_index=i, process_count=pc)
                  for i in range(pc)]
        iters = [s.epoch_at(cur["epoch"], cur["offset"]) for s in shards]
        for x, y in full[2:]:
            xs, ys = zip(*[next(it) for it in iters])
            np.testing.assert_array_equal(np.concatenate(xs), x)
            np.testing.assert_array_equal(np.concatenate(ys), y)


# ---------------------------------------------------------------------------
# Host prefetch
# ---------------------------------------------------------------------------

def test_host_prefetch_is_math_neutral_sync_free_and_instrumented(tmp_path, monkeypatch):
    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.utils import hostsync

    ds = TokenStreamDataset(_token_dir(tmp_path), global_batch_size=16, seed=21,
                            shuffle_block=16)
    ref = list(ds.epoch(0))
    obs_dir = str(tmp_path / "obs")
    monkeypatch.setenv("OBS_DIR", obs_dir)
    obs.reset()
    try:
        obs.configure_from_env()
        before = hostsync.accountant().count
        with hostsync.track():
            out = list(host_prefetch(ds.epoch(0), depth=3))
        assert hostsync.accountant().count == before
        obs.flush()
    finally:
        monkeypatch.delenv("OBS_DIR")
        obs.reset()
    _same(out, ref)
    events = []
    for name in os.listdir(obs_dir):
        if name.endswith(".jsonl"):
            with open(os.path.join(obs_dir, name)) as f:
                events += [json.loads(line) for line in f if line.strip()]
    names = {(e.get("kind"), e.get("name")) for e in events}
    for want in (("span", "data.wait"), ("gauge", "data.buffer_depth"),
                 ("counter", "data.bytes"), ("gauge", "data.bytes_per_s")):
        assert want in names, (want, names)
    assert sum(e["value"] for e in events if e.get("name") == "data.bytes") == \
        sum(x.nbytes + y.nbytes for x, y in ref)
    assert len(list(host_prefetch(ds.epoch(0), depth=0))) == len(ref)
    gen = host_prefetch(ds.epoch(0), depth=2)
    next(gen)
    gen.close()  # must not hang or leak the reader thread


def test_host_prefetch_passes_reader_errors_on():
    def boom():
        yield np.zeros((2, 2))
        raise RuntimeError("shard read failed")

    it = host_prefetch(boom(), depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="shard read failed"):
        list(it)


# ---------------------------------------------------------------------------
# Config knobs and the factory
# ---------------------------------------------------------------------------

ENVS = [
    {"STREAM_SHUFFLE_BLOCK": "512", "PREFETCH_HOST_BATCHES": "0", "DATA_FORMAT": "stream"},
    {"FAKE": "False", "DATA_DIR": "/d", "VAL_DATA_DIR": "/v", "NUM_WORKERS": "3",
     "WORKER_MODE": "process", "MULTIPROCESSING": "False"},
    {"FAKE": "0", "AZ_BATCHAI_INPUT_TRAIN": "/a", "DATA_DIR": "/d",
     "AZ_BATCHAI_INPUT_TEST": "/t", "VAL_DATA_DIR": "/v", "MULTIPROCESSING": "True"},
    {"MULTIPROCESSING": "no", "DATA_FORMAT": "tfrecord-native", "DATA_DIR": ""},
]


@pytest.mark.parametrize("env", ENVS, ids=["stream-knobs", "dirs-workers", "batchai",
                                           "multiprocessing-off"])
def test_config_knobs_parse_like_jax(env):
    import dataclasses

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu_torch.config import TrainConfig

    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_resolve_engine_refuses_what_jax_refuses():
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.training.loop import resolve_engine

    with pytest.raises(ValueError, match="STREAM_SHUFFLE_BLOCK"):
        resolve_engine(TrainConfig(stream_shuffle_block=0), device="cpu")
    with pytest.raises(ValueError, match="PREFETCH_HOST_BATCHES"):
        resolve_engine(TrainConfig(prefetch_host_batches=-1), device="cpu")
    assert resolve_engine(TrainConfig(prefetch_host_batches=0), device="cpu")[0] == "dp"


def test_make_dataset_resolves_stream(tmp_path):
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import make_dataset

    d = _token_dir(tmp_path)
    for fmt in ("stream", "auto"):
        cfg = TrainConfig(fake=False, data_dir=d, data_format=fmt, batch_size_per_device=2,
                          stream_shuffle_block=16)
        ds = make_dataset(cfg, train=True)
        assert isinstance(ds, TokenStreamDataset)
        assert ds.global_batch_size == 2 and ds.shuffle_block == 16 and ds.seed == cfg.seed
        assert make_dataset(cfg.replace(val_data_dir=d), train=False).seed == cfg.seed + 10_000
    with pytest.raises(ValueError, match="stream"):
        make_dataset(TrainConfig(fake=False, data_dir=d, data_format="sideways"), train=True)


# ---------------------------------------------------------------------------
# streamgen
# ---------------------------------------------------------------------------

def test_streamgen_cli_roundtrip_equals_jax_script(tmp_path, capsys):
    from distributeddeeplearning_tpu_torch import streamgen
    from scripts import streamgen as jax_streamgen

    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog. " * 30)
    out, ref = str(tmp_path / "shards"), str(tmp_path / "ref")
    args = ["tokens", "--corpus", str(corpus), "--seq-len", "16", "--shard-records", "32"]
    assert streamgen.main(args[:1] + ["--out", out] + args[1:]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["kind"] == "tokens" and summary["records"] > 0 and summary["out"] == out
    assert jax_streamgen.main(args[:1] + ["--out", ref] + args[1:]) == 0
    capsys.readouterr()
    assert _files(out) == _files(ref)
    idx = load_index(out)
    np.testing.assert_array_equal(idx.read("tokens", np.array([0]))[0],
                                  np.frombuffer(corpus.read_bytes()[:17], np.uint8)
                                  .astype(np.int32))
    ds = open_stream_dataset(out, global_batch_size=8, image_dtype=np.uint8)
    assert isinstance(ds, TokenStreamDataset) and ds.vocab_size == 256
    for kind, extra in (("tokens", ["--records", "40", "--seq-len", "8", "--vocab", "50"]),
                        ("records", ["--records", "20", "--image-size", "6",
                                     "--classes", "4", "--shard-records", "8"])):
        a, b = str(tmp_path / f"{kind}-a"), str(tmp_path / f"{kind}-b")
        assert streamgen.main([kind, "--out", a, *extra]) == 0
        assert jax_streamgen.main([kind, "--out", b, *extra]) == 0
        assert _files(a) == _files(b)
    capsys.readouterr()
    assert streamgen.main(["tokens", "--out", str(tmp_path / "none")]) == 2
    assert corpus_to_rows(b"0123456789", seq_len=4, stride=2).shape == (3, 5)
    with pytest.raises(ValueError, match="too short"):
        corpus_to_rows(b"abc", seq_len=16)
