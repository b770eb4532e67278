"""The port's ``fit`` on ``lm_tiny`` with ``attn_impl="pallas"`` (the
flash kernels' plain versions on the CPU) against the JAX package's
``fit`` with its Pallas kernels interpreted, on a 1-device mesh: f32,
vocab 64, T 64, 4 sequences a step, 2 epochs of 4 steps, the same
converted weights and numpy batches (each package's
``SyntheticTokenDataset``).

Limits: the history (``loss``, ``accuracy``, ``grad_norm``) within 1e-5
relative (1e-5 absolute below 1), the step and token counts equal, the
parameter updates within 2e-4 of their norm per parameter (plus 2**-23
of the parameter's norm, its f32 resolution) and 2e-5 all together, the
limits ``tests/test_torch_lm_train.py`` holds two steps to. Measured over
these eight steps: history 2.0e-7, updates 5.6e-6 per parameter at worst
and 1.2e-6 together.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import create_optimizer, create_train_state, loop

VOCAB, SEQ = 64, 64
CFG = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=4,
           compute_dtype="float32", base_lr=0.5, warmup_epochs=1, attn_impl="pallas",
           epochs=2, log_every_steps=0)
DATA = dict(length=16, global_batch_size=4, seq_len=SEQ, vocab_size=VOCAB, seed=3)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_lm_pallas_fit_matches_jax_fit():
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data import SyntheticTokenDataset as JaxTokens
    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import loop as jax_loop

    jcfg = JaxConfig(**CFG)
    jdata = JaxTokens(**DATA)
    jmodel = jax_get_model(jcfg.model, **jcfg.model_kwargs(), max_seq_len=SEQ)
    tx, _ = jax_opt(jcfg, jdata.steps_per_epoch, world_size=1)
    jstate = jax_state(jmodel, jcfg, tx, input_shape=(1, SEQ), input_dtype=jnp.int32)
    init = jax.tree.map(np.asarray, jstate.params)
    want = jax_loop.fit(jmodel, jcfg, jdata, mesh=create_mesh(devices=jax.devices()[:1]),
                        state=jstate, add_default_logger=False)
    want_params = jax.tree.map(np.asarray, want.state.params)

    cfg = TrainConfig(**CFG)
    data = SyntheticTokenDataset(**DATA)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=SEQ, device="cpu")
    tx, _ = create_optimizer(cfg, data.steps_per_epoch, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.params_from_flax(init))
    got = loop.fit(model, cfg, data, device="cpu", state=state, add_default_logger=False)

    assert got.state.step == 2 * data.steps_per_epoch == 8
    for g, w in zip(got.history, want.history):
        assert g.keys() == w.keys()
        assert g["epoch_images"] == w["epoch_images"] and g["global_step"] == w["global_step"]
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    p0 = dict(_leaves(init))
    pw = dict(_leaves(want_params))
    pg = dict(_leaves(convert.params_to_flax(model.state_dict())))
    assert pw.keys() == pg.keys() == p0.keys()
    num = den = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= 2e-4 * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        num, den = num + e * e, den + np.sum(dw * dw)
    assert np.sqrt(num) <= 2e-5 * np.sqrt(den)
