"""The port's quantized serving tier against the JAX package's, fp8 KV
(``float8_e4m3fn`` codes with f32 scales; ``test_torch_serving_quant.py``
has the int8 KV tier and the accounting, teacher-forcing and config
oracles).

Greedy streams of the JAX ``Server`` and the port's ``Server`` on the
same converted f32 ``lm_tiny`` weights are identical with fp8 KV and
fp8 weights on both layouts through both decode paths, and with int8
weights; after the same stream the pools hold JAX's fp8 codes within one
step of their bit pattern (``assert_pools_close``).
"""

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
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.serving import Request, Server

PAGED = dict(kv_layout="paged", block_size=4)


@pytest.fixture(scope="module")
def jax_lm():
    return jax_model_params()


@pytest.fixture(scope="module")
def state_dict(jax_lm):
    return convert.params_from_flax(jax_lm[1])


@pytest.mark.parametrize(
    "kv,w,kw",
    [
        pytest.param("fp8", "fp8", {}, id="fp8-fp8-dense-xla"),
        pytest.param("fp8", "fp8", PAGED, id="fp8-fp8-paged-xla"),
        pytest.param("fp8", "fp8", dict(PAGED, decode_kernel="fused"),
                     id="fp8-fp8-paged-fused"),
        pytest.param("fp8", "int8", dict(decode_kernel="fused"), id="fp8-int8-dense-fused"),
    ],
)
def test_fp8_greedy_streams_and_pools_match_jax_server(jax_lm, state_dict, kv, w, kw):
    model, params = jax_lm
    reqs = requests()
    jax_engine = JaxEngine(model, params, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS,
                           kv_dtype=kv, weight_dtype=w, **kw)
    ref = serve(JaxServer, JaxRequest, jax_engine, reqs)
    engine = port_engine(state_dict, kv_dtype=kv, weight_dtype=w, **kw)
    out = serve(Server, Request, engine, reqs)
    assert out == ref
    assert engine.kv_dtype == kv and engine._stores[0][0].dtype == torch.float8_e4m3fn
    if kw.get("kv_layout") == "paged":
        assert engine.allocator.snapshot() == jax_engine.allocator.snapshot()
    assert_pools_close(jax_engine, engine, kv)
