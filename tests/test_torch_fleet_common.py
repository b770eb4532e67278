"""Shared set-up of the fleet parity tests (``test_torch_fleet*.py``,
``test_torch_slot_transfer.py``; this module holds no test of its own):
the JAX package's ``lm_tiny`` (f32, 64-token vocab, ``MAX_LEN`` 32, its
own seed-0 init, as ``tests/test_serving_fleet.py`` builds it) and the
same weights carried into the port through the converter; port replicas
on the CPU; and the JAX package's sequential ``generate`` as the oracle
every port stream is held to, bit for bit (memoized: each prompt shape
compiles once a module)."""

import numpy as np
import pytest
import torch
from _torch_serving_common import MAX_LEN, VOCAB, jax_model_params

_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: six workers at eight threads each run the
    port's eager CPU ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_lm():
    if "jax" not in _CACHE:
        _CACHE["jax"] = jax_model_params()
    return _CACHE["jax"]


def state_dict():
    """The JAX init's weights as the port's f32 state dict."""
    if "sd" not in _CACHE:
        from distributeddeeplearning_tpu_torch.models import convert

        _CACHE["sd"] = convert.params_from_flax(jax_lm()[1])
    return _CACHE["sd"]


def port_model(max_len=MAX_LEN):
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM

    return TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=max_len,
                         dtype=torch.float32, device="cpu")


def replica(k, scfg, *, pool="mixed", model=None, params=None, max_len=MAX_LEN, **kw):
    """An unstarted port replica on the CPU over the converted weights."""
    from distributeddeeplearning_tpu_torch.serving import Replica

    return Replica(k, model if model is not None else port_model(max_len),
                   state_dict() if params is None else params, scfg,
                   max_len=max_len, pool=pool, device="cpu", **kw)


def jax_ref(prompt, max_new, seed=None, **kw):
    """JAX's sequential ``generate`` of ``prompt``: ``[Tp + max_new]``
    (``seed`` n samples under ``PRNGKey(n)``, the key a port request's
    ``rng=n`` makes)."""
    import jax

    from distributeddeeplearning_tpu.inference import generate

    key = (np.asarray(prompt, np.int32).tobytes(), int(max_new), seed,
           tuple(sorted(kw.items())))
    if key not in _CACHE:
        model, params = jax_lm()
        rng = None if seed is None else jax.random.PRNGKey(seed)
        _CACHE[key] = np.asarray(generate(
            model, params, np.asarray(prompt, np.int32)[None], max_new_tokens=max_new,
            rng=rng, **kw))[0]
    return _CACHE[key]


def jax_ref_new(prompt, max_new, **kw):
    """The NEW tokens of :func:`jax_ref`, as ints."""
    return [int(t) for t in jax_ref(prompt, max_new, **kw)[len(prompt):]]


def prompt(rng, n=5):
    return rng.randint(0, VOCAB, size=(n,)).astype(np.int32)


def pump(router, until, limit=6000):
    """Step the router until ``until()`` or idle; bounded."""
    for _ in range(limit):
        if until():
            return True
        if not router.step():
            break
    return until()
