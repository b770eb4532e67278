"""Shared set-up of the quantized and speculative serving parity tests:
the JAX package's ``lm_tiny`` (f32, ``MAX_LEN`` 32, its own init) and
the same weights carried into the port, a request mix and a drain
helper. An f32 model keeps the two stacks' logits within f32 round-off
of each other, far inside the gap between a tiny random model's top two
logits, so greedy streams can be held equal token for token."""

import numpy as np
import torch

VOCAB, MAX_LEN = 64, 32
BUCKETS = (8, 16)
SHARED = np.arange(1, 9, dtype=np.int32)  # two full blocks of 4


def jax_model_params():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM

    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, MAX_LEN), jnp.int32),
                           train=False)
    return model, nn.unbox(variables["params"])


def port_engine(state_dict, **kw):
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.serving import SlotEngine

    model = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                          dtype=torch.float32, device="cpu")
    return SlotEngine(model, state_dict, num_slots=3, max_len=MAX_LEN,
                      buckets=BUCKETS, device="cpu", **kw)


def requests(max_new=(6, 7, 4, 6, 5, 9)):
    """(prompt, max_new_tokens): mixed lengths; the 2nd and 5th share an
    8-token prefix, so the 5th hits a paged engine's prefix cache."""
    rng = np.random.RandomState(11)
    r = lambda n: rng.randint(0, VOCAB, size=(n,)).astype(np.int32)  # noqa: E731
    prompts = [r(3), np.concatenate([SHARED, r(3)]), r(12), r(16),
               np.concatenate([SHARED, r(6)]), r(5)]
    return list(zip(prompts, max_new))


def serve(server_cls, request_cls, engine, reqs, **req_kw):
    """Drain ``reqs`` through a fresh server over ``engine``; returns
    the generated tokens of each request."""
    server = server_cls(engine, prefills_per_step=1)
    handles = [server.submit(request_cls(prompt=p, max_new_tokens=m, **req_kw))
               for p, m in reqs]
    server.drain()
    assert all(h.status == "done" for h in handles)
    return [[int(t) for t in h.new_tokens] for h in handles]


def assert_pools_close(jax_engine, engine, kind, max_share=0.01):
    """The port engine's quantized pools against the JAX engine's after
    the same stream: codes within one code (fp8: one step of the bit
    pattern), and at most ``max_share`` of them apart at all (the share
    is in the message). Scales: layer 0's K/V come from the same weights
    and embeddings through one matmul, so they agree to f32 round-off
    (2**-20 relative; measured 6e-7). Deeper layers read attention over
    the codes below them, and one code apart is a step of 1/127 of its
    slice's amax: on ``lm_tiny`` that moved layer 1's scales by up to
    1e-4 relative, held to 2**-10."""
    from flax import traverse_util

    flat = traverse_util.flatten_dict(dict(jax_engine._pool))
    prefix = "paged" if engine.kv_layout == "paged" else "cached"
    k, v, ks, vs = engine._stores
    differ = total = 0
    for layer in range(len(k)):
        for name, codes, scales in (("k", k, ks), ("v", v, vs)):
            where = f"layer {layer} {name}"
            jc = np.asarray(flat[(f"block{layer}", "attn", f"{prefix}_{name}")])
            js = np.asarray(flat[(f"block{layer}", "attn", f"{prefix}_{name}_scale")])
            if kind == "int8":
                got, ref = codes[layer].numpy().astype(np.int32), jc.astype(np.int32)
            else:
                got = codes[layer].view(torch.uint8).numpy().astype(np.int32)
                ref = jc.view(np.uint8).astype(np.int32)
            gap = np.abs(got - ref)
            differ += int((gap > 0).sum())
            total += gap.size
            assert gap.max() <= 1, f"{where}: codes {gap.max()} apart"
            rel = np.abs(scales[layer].numpy() - js) / np.maximum(np.abs(js), 1e-30)
            lim = 2 ** -20 if layer == 0 else 2 ** -10
            assert rel.max() <= lim, f"{where}: scales {rel.max():.3e} apart (relative)"
    share = differ / total
    assert share <= max_share, f"{differ} of {total} codes ({share:.2e}) differ by one"
