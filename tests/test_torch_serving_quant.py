"""The port's quantized serving tier against the JAX package's, int8 KV
(``test_torch_serving_quant_fp8.py`` has the fp8 KV tier).

* Greedy streams: the JAX ``Server`` and the port's ``Server``, on the
  same converted f32 ``lm_tiny`` weights, emit identical tokens with
  int8 KV and int8 weights on the dense and paged layouts, through the
  plain (``xla``) and the kernel (``fused``, Pallas in interpret mode /
  the plain version on the CPU) decode paths, and with fp8 weights.
* The pools: after the same stream the int8 pool holds JAX's codes
  within one code (``assert_pools_close`` gives the scale limits). The
  two engines' K/V differ by f32 round-off (XLA's and PyTorch's
  matmuls; XLA also rewrites ``amax / 127`` under ``jit`` as ``amax *
  (1/127)``), which can move a value across a rounding boundary.
* ``byte_accounting()`` equals JAX's field for field; ``force_token``
  replaying the engine's own stream is a no-op; ``ServeConfig`` reads
  the quantized knobs as JAX's does; an fp8 request on a device that
  cannot round-trip fp8 falls back to int8.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_serving_common import (
    BUCKETS,
    MAX_LEN,
    assert_pools_close,
    jax_model_params,
    port_engine,
    requests,
    serve,
)

from distributeddeeplearning_tpu.serving import Request as JaxRequest
from distributeddeeplearning_tpu.serving import Server as JaxServer
from distributeddeeplearning_tpu.serving import SlotEngine as JaxEngine
from distributeddeeplearning_tpu.serving.scheduler import ServeConfig as JaxServeConfig
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.ops import quant
from distributeddeeplearning_tpu_torch.serving import ReqSpec, Request, ServeConfig, Server

PAGED = dict(kv_layout="paged", block_size=4)


@pytest.fixture(scope="module")
def jax_lm():
    return jax_model_params()


@pytest.fixture(scope="module")
def state_dict(jax_lm):
    return convert.params_from_flax(jax_lm[1])


def _jax_engine(jax_lm, **kw):
    model, params = jax_lm
    return JaxEngine(model, params, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS, **kw)


@pytest.mark.parametrize(
    "kv,w,kw",
    [
        pytest.param("int8", "int8", {}, id="int8-int8-dense-xla"),
        pytest.param("int8", "int8", dict(decode_kernel="fused"), id="int8-int8-dense-fused"),
        pytest.param("int8", "int8", dict(PAGED, decode_kernel="fused"),
                     id="int8-int8-paged-fused"),
        pytest.param("int8", "fp8", PAGED, id="int8-fp8-paged-xla"),
    ],
)
def test_quantized_greedy_streams_match_jax_server(jax_lm, state_dict, kv, w, kw):
    reqs = requests()
    jax_engine = _jax_engine(jax_lm, kv_dtype=kv, weight_dtype=w, **kw)
    ref = serve(JaxServer, JaxRequest, jax_engine, reqs)
    engine = port_engine(state_dict, kv_dtype=kv, weight_dtype=w, **kw)
    out = serve(Server, Request, engine, reqs)
    assert out == ref
    assert engine.kv_dtype == kv and engine.weight_dtype == w
    if kw.get("kv_layout") == "paged":
        assert engine.allocator.snapshot() == jax_engine.allocator.snapshot()
        assert_pools_close(jax_engine, engine, kv)


@pytest.mark.parametrize("kv,w", [("int8", "int8"), ("bf16", "fp8"), ("fp8", "bf16")])
@pytest.mark.parametrize("layout", [{}, PAGED], ids=["dense", "paged"])
def test_byte_accounting_equals_jax(jax_lm, state_dict, kv, w, layout):
    jax_acct = _jax_engine(jax_lm, kv_dtype=kv, weight_dtype=w, **layout).byte_accounting()
    acct = port_engine(state_dict, kv_dtype=kv, weight_dtype=w, **layout).byte_accounting()
    assert acct == jax_acct
    native = port_engine(state_dict, **layout).byte_accounting()
    if kv != "bf16":  # codes + scales, never the payload alone
        assert acct["kv_bytes_per_token"] == 2 * 2 * 4 * (32 * 1 + 4)
        assert acct["kv_bytes_per_token"] < native["kv_bytes_per_token"] / 3
    if w != "bf16":
        assert acct["param_bytes"] < native["param_bytes"]


def test_force_token_self_replay_is_noop(state_dict):
    """Forcing the engine's own greedy stream back in reproduces it
    exactly; forcing an empty slot is an error."""
    engine = port_engine(state_dict, kv_dtype="int8", weight_dtype="int8")
    prompt = np.random.RandomState(9).randint(0, 64, size=6).astype(np.int32)
    first, _ = engine.prefill(0, ReqSpec(prompt=prompt, max_new_tokens=8))
    free = [first]
    for _ in range(7):
        [(_, tok, _)] = engine.decode_step()
        free.append(tok)
    engine.release(0)
    forced = [engine.prefill(0, ReqSpec(prompt=prompt, max_new_tokens=8))[0]]
    for i in range(7):
        engine.force_token(0, free[i])
        [(_, tok, _)] = engine.decode_step()
        forced.append(tok)
    engine.release(0)
    assert forced == free
    with pytest.raises(ValueError, match="not occupied"):
        engine.force_token(1, 0)


def test_serve_config_quant_env_resolves_like_jax():
    for env in ({"SERVE_KV_DTYPE": "int8", "SERVE_WEIGHT_DTYPE": "int8"},
                {"SERVE_KV_DTYPE": "fp8", "SERVE_WEIGHT_DTYPE": "fp8",
                 "SERVE_DECODE_KERNEL": "fused", "SERVE_KV_LAYOUT": "paged"}):
        cfg, ref = ServeConfig.from_env(env), JaxServeConfig.from_env(env)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.engine_kwargs() == ref.engine_kwargs()
    for bad in (dict(kv_dtype="int4"), dict(weight_dtype="fp4")):
        with pytest.raises(ValueError) as port_err:
            ServeConfig(**bad).engine_kwargs()
        with pytest.raises(ValueError) as jax_err:
            JaxServeConfig(**bad).engine_kwargs()
        assert str(port_err.value) == str(jax_err.value)


def test_fp8_falls_back_to_int8_where_the_device_cannot(state_dict, monkeypatch):
    """The device gate: where the fp8 probe fails, the engine serves the
    int8 tier instead (logged), visibly in its dtypes and pools."""
    monkeypatch.setattr(quant, "fp8_supported", lambda device: False)
    engine = port_engine(state_dict, kv_dtype="fp8", weight_dtype="fp8")
    assert engine.kv_dtype == "int8" and engine.weight_dtype == "int8"
    engine.warmup()
    assert engine._stores[0][0].dtype == torch.int8
    assert engine.model.blocks[0].attn.qkv.weight_q.dtype == torch.int8
