"""The port's ``fit`` on token shards (``FAKE=False``, ``DATA_DIR`` a
stream of ``[T+1]`` rows) against the JAX package's, the cursor resume
and the pretrain -> serve tool:

* ``lm_tiny`` with ``attn_impl="pallas"`` (the flash kernels' plain
  versions; JAX's Pallas kernels interpreted) on token shards, against
  JAX's ``fit`` on a 1-device mesh from the same converted weights: the
  history within 1e-5 relative and the updates within
  ``tests/test_torch_loop_lm.py``'s limits;
* a mid-epoch resume from the manifest's ``data_cursor`` (checkpoints
  rolled back to step 6 of 4-step epochs) ends BITWISE equal to the
  uninterrupted run; the resume seeks (a ``resume_seek`` point,
  ``data.resume_skip_batches`` 0, no ``resume_skip``), the ``data.wait``
  spans flow, and the manifests carry the cursor (twin of
  ``tests/test_stream.py:361``);
* ``python -m distributeddeeplearning_tpu_torch.stream_bench`` at
  ``lm_tiny`` on the CPU (paged KV, the fused decode kernel's plain
  version): the restored parameters equal the trained ones bit for bit
  and the served streams equal ``inference.generate`` (twin of
  ``tests/test_stream.py:479``).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import make_dataset
from distributeddeeplearning_tpu_torch.data.stream import synthetic_rows, write_token_shards
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import create_optimizer, create_train_state, loop


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_make_dataset(cfg):
    """JAX's ``make_dataset`` sizing the global batch for one device (the
    suite's JAX runs on 8 forced CPU devices; the fit runs on a 1-device
    mesh)."""
    from unittest import mock

    from distributeddeeplearning_tpu.data import make_dataset as jax_make_dataset

    with mock.patch.object(jax, "device_count", lambda *a, **k: 1):
        return jax_make_dataset(cfg, train=True)


VOCAB, SEQ = 64, 64
LM_CFG = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=4,
              compute_dtype="float32", base_lr=0.5, warmup_epochs=1, attn_impl="pallas",
              epochs=2, log_every_steps=0, fake=False, stream_shuffle_block=8)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_lm_pallas_fit_on_token_shards_matches_jax_fit(tmp_path):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import loop as jax_loop

    d = str(tmp_path / "tokens")
    write_token_shards(d, synthetic_rows(16, seq_len=SEQ, vocab_size=VOCAB, seed=3),
                       seq_len=SEQ, vocab_size=VOCAB, shard_records=5)
    jcfg = JaxConfig(**LM_CFG, data_dir=d)
    jdata = _jax_make_dataset(jcfg)
    jmodel = jax_get_model(jcfg.model, **jcfg.model_kwargs(), max_seq_len=SEQ)
    tx, _ = jax_opt(jcfg, jdata.steps_per_epoch, world_size=1)
    jstate = jax_state(jmodel, jcfg, tx, input_shape=(1, SEQ), input_dtype=jnp.int32)
    init = jax.tree.map(np.asarray, jstate.params)
    want = jax_loop.fit(jmodel, jcfg, jdata, mesh=create_mesh(devices=jax.devices()[:1]),
                        state=jstate, add_default_logger=False)
    want_params = jax.tree.map(np.asarray, want.state.params)

    cfg = TrainConfig(**LM_CFG, data_dir=d)
    data = make_dataset(cfg, train=True)
    assert type(data).__name__ == "TokenStreamDataset" and data.steps_per_epoch == 4
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=SEQ, device="cpu")
    tx, _ = create_optimizer(cfg, data.steps_per_epoch, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.params_from_flax(init))
    got = loop.fit(model, cfg, data, device="cpu", state=state, add_default_logger=False)
    assert got.state.step == 8
    for g, w in zip(got.history, want.history):
        assert g.keys() == w.keys()
        assert g["epoch_images"] == w["epoch_images"] and g["global_step"] == w["global_step"]
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    p0, pw = dict(_leaves(init)), dict(_leaves(want_params))
    pg = dict(_leaves(convert.params_to_flax(model.state_dict())))
    assert pw.keys() == pg.keys() == p0.keys()
    num = den = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= 2e-4 * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        num, den = num + e * e, den + np.sum(dw * dw)
    assert np.sqrt(num) <= 2e-5 * np.sqrt(den)


def _events(obs_dir):
    out = []
    for name in os.listdir(obs_dir):
        if name.endswith(".jsonl"):
            with open(os.path.join(obs_dir, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def _lm_fit(shard_dir, **kw):
    cfg = TrainConfig(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=4, epochs=2,
                      compute_dtype="float32", weight_decay=0.0, log_every_steps=0,
                      fake=False, data_dir=shard_dir, prefetch_host_batches=2, **kw)
    data = make_dataset(cfg, train=True)
    model = get_model("lm_tiny", num_classes=VOCAB, dtype="float32", max_seq_len=16,
                      device="cpu")
    return loop.fit(model, cfg, data, device="cpu", add_default_logger=False)


def test_resume_from_manifest_cursor_is_bitwise_with_zero_replay(tmp_path, monkeypatch):
    from distributeddeeplearning_tpu_torch import faults, obs
    from distributeddeeplearning_tpu_torch.training.checkpoint import CheckpointManager

    d = str(tmp_path / "tokens")
    write_token_shards(d, synthetic_rows(16, seq_len=16, vocab_size=VOCAB, seed=7),
                       seq_len=16, vocab_size=VOCAB, shard_records=6)
    ref = _lm_fit(d)
    ck = str(tmp_path / "ck")
    kw = dict(model_dir=ck, checkpoint_every_steps=3, checkpoint_async=False,
              checkpoint_keep=10)
    full = _lm_fit(d, **kw)
    ref_sd = ref.state.model.state_dict()
    for k, v in full.state.model.state_dict().items():
        assert torch.equal(ref_sd[k], v), k
    steps = faults.checkpoint_steps(ck)
    assert steps == [3, 4, 6, 8], steps
    for s in steps:
        if s > 6:  # "preempted at step 6": mid-epoch 1, 2 of 4 batches done
            shutil.rmtree(os.path.join(ck, str(s)))

    obs_dir = str(tmp_path / "obs")
    monkeypatch.setenv("OBS_DIR", obs_dir)
    obs.reset()
    try:
        resumed = _lm_fit(d, **kw)
        obs.flush()
    finally:
        monkeypatch.delenv("OBS_DIR")
        obs.reset()
    assert resumed.history[0]["epoch_images"] == 8  # 2 of 4 batches left
    assert resumed.state.step == 8
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(ref_sd[k], v), k
    for a, b in zip(ref.state.opt_state["trace"], resumed.state.opt_state["trace"]):
        assert torch.equal(a, b)
    evs = _events(obs_dir)
    points = [e.get("name") for e in evs if e.get("kind") == "point"]
    assert "resume_seek" in points and "resume_skip" not in points
    skips = [e["value"] for e in evs
             if e.get("kind") == "gauge" and e.get("name") == "data.resume_skip_batches"]
    assert skips and all(v == 0.0 for v in skips)
    assert any(e.get("kind") == "span" and e.get("name") == "data.wait" for e in evs)

    mgr = CheckpointManager(ck, save_every_steps=3)
    mgr.restore(resumed.state, 6)
    cur = (mgr.last_manifest or {}).get("data_cursor")
    assert cur is not None and (cur["epoch"], cur["offset"]) == (1, 2)
    assert cur["records"] == 16 and cur["seed"] == 42 and cur["kind"] == "tokens"
    mgr.restore(resumed.state)
    end = (mgr.last_manifest or {}).get("data_cursor")
    mgr.close()
    assert end and (end["epoch"], end["offset"]) == (2, 0)


def test_stream_bench_restores_bitwise_and_serves_generate(monkeypatch, capsys):
    from distributeddeeplearning_tpu_torch import stream_bench

    for k in list(os.environ):
        if k.startswith(("SERVE_", "BENCH_", "STREAM_")):
            monkeypatch.delenv(k, raising=False)
    for k, v in {"BENCH_DEVICE": "cpu", "STREAM_RECORDS": "96", "STREAM_SEQ_LEN": "32",
                 "STREAM_EPOCHS": "1", "SERVE_MAX_NEW": "8", "SERVE_KV_LAYOUT": "paged",
                 "SERVE_DECODE_KERNEL": "fused"}.items():
        monkeypatch.setenv(k, v)
    assert stream_bench.main([]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = record["detail"]
    assert record["metric"] == "lm_stream_pretrain_tokens_per_sec" and record["value"] > 0
    assert d["restore_roundtrip"] and d["serve_match"]
    assert d["platform"] == "cpu" and d["model"] == "lm_tiny" and d["records"] == 96
    assert (d["serve_kv_layout"], d["serve_decode_kernel"]) == ("paged", "fused")
    cur = d["manifest_data_cursor"]
    assert (cur["epoch"], cur["offset"], cur["records"]) == (1, 0, 96)
    assert record["host_sync_count"] == 1 + 6  # one an epoch, one a save (every 2 of 12 steps)
