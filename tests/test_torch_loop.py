"""The port's training loop (``training/loop.fit``) against the JAX
package's: ``fit`` on a ResNet-18 (64 px, 10 classes, f32, 4 images a step, label
  smoothing 0.1, 2 epochs of 4 steps, ``VALIDATION`` on over an exact
  eval set of 6 images, its last batch padded) against JAX's ``fit`` on a
  1-device mesh from the same converted weights and the same numpy
  batches (each package's ``SyntheticImageDataset``): every history entry
  (``loss``, ``accuracy``, ``grad_norm``, ``val_loss``, ``val_top1``,
  ``val_top5``) within 1e-4 relative (1e-4 absolute below 1), the sample
  and image counts equal; the parameter updates within 3 % of their norm
  per parameter (plus 2**-23 of the parameter's norm, its f32
  resolution) and 0.5 % all together, the running statistics within
  1e-4 of their largest value (``_torch_train_common.assert_step_matches``'s
  limits; measured over these eight steps: history 2.2e-7, updates
  3.9e-3 per parameter at worst and 4.8e-6 together, running statistics
  4.8e-6);

``tests/test_torch_loop_lm.py`` holds ``lm_tiny`` with the flash kernels,
``tests/test_torch_loop_sync.py`` the loop's sync-free contract and
non-finite guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    loop,
)

SIZE, CLASSES = 64, 10
CFG = dict(model="resnet18", num_classes=CLASSES, image_size=SIZE, batch_size_per_device=4,
           compute_dtype="float32", base_lr=0.01, label_smoothing=0.1, warmup_epochs=1,
           fake_data_length=16, epochs=2, validation=True, log_every_steps=0)
TRAIN = dict(length=16, global_batch_size=4, image_size=SIZE, num_classes=CLASSES, seed=42)
EVAL = dict(length=6, global_batch_size=4, image_size=SIZE, num_classes=CLASSES, seed=11,
            exact=True)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _jax_fit():
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data import SyntheticImageDataset as JaxImages
    from distributeddeeplearning_tpu.models.resnet import ResNet
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import loop as jax_loop

    cfg = JaxConfig(**CFG)
    data = JaxImages(**TRAIN)
    model = ResNet(depth=18, num_classes=CLASSES, dtype=jnp.float32)
    tx, _ = jax_opt(cfg, data.steps_per_epoch, world_size=1)
    state = jax_state(model, cfg, tx, input_shape=(1, SIZE, SIZE, 3))
    init = (jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats))
    res = jax_loop.fit(model, cfg, data, mesh=create_mesh(devices=jax.devices()[:1]),
                       state=state, eval_data=JaxImages(**EVAL), add_default_logger=False)
    final = (jax.tree.map(np.asarray, res.state.params),
             jax.tree.map(np.asarray, res.state.batch_stats))
    return init, res.history, final


def test_fit_matches_jax_fit():
    from _torch_train_common import assert_step_matches

    init, want_history, want_final = _jax_fit()
    cfg = TrainConfig(**CFG)
    data = SyntheticImageDataset(**TRAIN)
    model = get_model(cfg.model, num_classes=CLASSES, dtype=cfg.compute_dtype, device="cpu")
    tx, _ = create_optimizer(cfg, data.steps_per_epoch, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.resnet_params_from_flax(*init))
    res = loop.fit(model, cfg, data, device="cpu", state=state,
                   eval_data=SyntheticImageDataset(**EVAL), add_default_logger=False)
    assert len(res.history) == len(want_history) == 2
    assert res.state.step == 2 * data.steps_per_epoch
    for got, want in zip(res.history, want_history):
        assert got.keys() == want.keys()
        for k in ("epoch_images", "global_step", "val_samples"):
            assert got[k] == want[k], k
        assert got["val_samples"] == 6
        for k in ("loss", "accuracy", "grad_norm", "val_loss", "val_top1", "val_top5"):
            assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    # assert_step_matches re-checks metrics per step; the history's epoch
    # means were checked above, so hand it none.
    assert_step_matches(init, [], want_final, [],
                        convert.resnet_params_to_flax(model.state_dict()))
