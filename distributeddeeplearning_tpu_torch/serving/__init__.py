"""Continuous-batching serving tier of the port: slot engine over a
dense or paged KV store (compute dtype, int8 or fp8) whose closed
program set is captured as CUDA graphs at ``warmup`` (``ProgramSpec``),
prefix cache, per-slot sampling as data, the speculative tier (int8
self-draft or n-gram proposals, batched verify), the request scheduler
with static or adaptive admission (``AdaptiveAdmissionPolicy`` reads the
live plane's rollup), and the seeded load generator (``loadgen``).

    from distributeddeeplearning_tpu_torch.serving import Request, Server
    server = Server.build(model, params)   # SERVE_* env, device "cuda"
    h = server.submit(Request(prompt=tokens, max_new_tokens=64))
    server.drain(); h.result()
"""

from distributeddeeplearning_tpu_torch.serving.blocks import (
    TRASH_BLOCK,
    BlockAllocator,
    BlockPoolExhausted,
    hash_prefix_chain,
)
from distributeddeeplearning_tpu_torch.serving.engine import (
    ProgramSpec,
    ReqSpec,
    SlotEngine,
    default_buckets,
)
from distributeddeeplearning_tpu_torch.serving.keys import request_key_ladder
from distributeddeeplearning_tpu_torch.serving.sampling import (
    DEFAULT_TOP_K_CAP,
    sample_slot,
    sample_slots,
    spec_verify_slots,
)
from distributeddeeplearning_tpu_torch.serving.spec import NgramDrafter
from distributeddeeplearning_tpu_torch.serving.scheduler import (
    AdaptiveAdmissionPolicy,
    AdmissionPolicy,
    QueueFull,
    Request,
    RequestHandle,
    ServeConfig,
    Server,
)

__all__ = [
    "AdaptiveAdmissionPolicy",
    "AdmissionPolicy",
    "BlockAllocator",
    "BlockPoolExhausted",
    "DEFAULT_TOP_K_CAP",
    "NgramDrafter",
    "ProgramSpec",
    "QueueFull",
    "ReqSpec",
    "Request",
    "RequestHandle",
    "ServeConfig",
    "Server",
    "SlotEngine",
    "TRASH_BLOCK",
    "default_buckets",
    "hash_prefix_chain",
    "request_key_ladder",
    "sample_slot",
    "sample_slots",
    "spec_verify_slots",
]
