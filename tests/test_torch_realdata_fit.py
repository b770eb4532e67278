"""The port's ``fit`` on real images (``FAKE=False``, ``DATA_DIR``)
against the JAX package's ``fit`` on a 1-device mesh, from the same
converted weights, each package's ``make_dataset`` reading the same
files: ResNet-18 (64 px, 8 classes, f32, 4 images a step, 2 epochs of 4
steps; at 32 px stage 4 normalises 4 values a channel and amplifies f32
round-off past the running statistics' limit, as
``tests/test_torch_loop.py`` notes) from a record stream
(``DATA_FORMAT=auto`` finds the ``stream_index.json``;
``PREFETCH_HOST_BATCHES=2``) and from an ImageFolder JPEG tree: the
epoch metrics within 1e-4 relative (1e-4 absolute below 1), the image
counts equal, and the final state within
``_torch_train_common.assert_step_matches``'s limits
(``tests/test_torch_loop.py``'s tolerance). The token-shard half is
``tests/test_torch_realdata_fit_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import make_dataset
from distributeddeeplearning_tpu_torch.data.stream import synthetic_records, write_record_shards
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import create_optimizer, create_train_state, loop

SIZE, CLASSES = 64, 8
CFG = dict(model="resnet18", num_classes=CLASSES, image_size=SIZE, batch_size_per_device=4,
           compute_dtype="float32", base_lr=0.01, label_smoothing=0.1, warmup_epochs=1,
           epochs=2, log_every_steps=0, fake=False, stream_shuffle_block=8,
           prefetch_host_batches=2, num_workers=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def record_stream(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("records") / "shards")
    write_record_shards(d, synthetic_records(16, image_size=SIZE, num_classes=CLASSES, seed=5),
                        image_size=SIZE, num_classes=CLASSES, shard_records=6)
    return d


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(1)
    for c in range(CLASSES):
        (root / f"class{c}").mkdir()
        for i in range(2):
            h, w = rng.randint(60, 81, size=2)
            Image.fromarray(rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)).save(
                root / f"class{c}" / f"{i}.jpg")
    return str(root)


def _jax_make_dataset(cfg):
    """JAX's ``make_dataset`` sizing the global batch for one device (the
    suite's JAX runs on 8 forced CPU devices; the fits run on a 1-device
    mesh)."""
    from unittest import mock

    from distributeddeeplearning_tpu.data import make_dataset as jax_make_dataset

    with mock.patch.object(jax, "device_count", lambda *a, **k: 1):
        return jax_make_dataset(cfg, train=True)


def _jax_resnet_fit(data_dir):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.models.resnet import ResNet
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import loop as jax_loop

    cfg = JaxConfig(**CFG, data_dir=data_dir)
    data = _jax_make_dataset(cfg)
    model = ResNet(depth=18, num_classes=CLASSES, dtype=jnp.float32)
    tx, _ = jax_opt(cfg, data.steps_per_epoch, world_size=1)
    state = jax_state(model, cfg, tx, input_shape=(1, SIZE, SIZE, 3))
    init = (jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats))
    res = jax_loop.fit(model, cfg, data, mesh=create_mesh(devices=jax.devices()[:1]),
                       state=state, add_default_logger=False)
    final = (jax.tree.map(np.asarray, res.state.params),
             jax.tree.map(np.asarray, res.state.batch_stats))
    return type(data).__name__, init, res.history, final


@pytest.mark.parametrize("layout", ["record-stream", "imagefolder"])
def test_resnet_fit_on_real_data_matches_jax_fit(layout, record_stream, jpeg_tree):
    from _torch_train_common import assert_step_matches

    data_dir = record_stream if layout == "record-stream" else jpeg_tree
    kind, init, want_history, want_final = _jax_resnet_fit(data_dir)
    cfg = TrainConfig.from_env({"FAKE": "False", "DATA_DIR": data_dir}).replace(
        **{k: v for k, v in CFG.items() if k != "fake"})
    data = make_dataset(cfg, train=True)
    assert type(data).__name__ == kind == ("RecordStreamDataset" if layout == "record-stream"
                                           else "ImageFolderDataset")
    assert data.steps_per_epoch == 4
    model = get_model(cfg.model, num_classes=CLASSES, dtype=cfg.compute_dtype, device="cpu")
    tx, _ = create_optimizer(cfg, data.steps_per_epoch, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.resnet_params_from_flax(*init))
    res = loop.fit(model, cfg, data, device="cpu", state=state, add_default_logger=False)
    assert len(res.history) == len(want_history) == 2
    for got, want in zip(res.history, want_history):
        assert got.keys() == want.keys()
        assert got["epoch_images"] == want["epoch_images"] == 16
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    assert_step_matches(init, [], want_final, [],
                        convert.resnet_params_to_flax(model.state_dict()))
