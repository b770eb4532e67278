"""Continuous-batching serving tier of the port: slot engine over a
dense or paged KV store (compute dtype, int8 or fp8) whose closed
program set is captured as CUDA graphs at ``warmup`` (``ProgramSpec``),
prefix cache, per-slot sampling as data, the speculative tier (int8
self-draft or n-gram proposals, batched verify), the request scheduler
with static or adaptive admission (``AdaptiveAdmissionPolicy`` reads the
live plane's rollup), the brownout ladder, slot export/import for
disaggregated pools and migration, the chaos plane (``chaos``), the
fleet (``fleet``: replicas, router, controller) and the seeded load
generator (``loadgen``).

    from distributeddeeplearning_tpu_torch.serving import Request, Server
    server = Server.build(model, params)   # SERVE_* env, device "cuda"
    h = server.submit(Request(prompt=tokens, max_new_tokens=64))
    server.drain(); h.result()
"""

from distributeddeeplearning_tpu_torch.serving.blocks import (
    TRASH_BLOCK,
    BlockAllocator,
    BlockPoolExhausted,
    PrefixDirectory,
    hash_prefix_chain,
    prompt_key,
)
from distributeddeeplearning_tpu_torch.serving.chaos import (
    ChaosCrash,
    ChaosInjector,
    FleetFault,
    SpliceMismatch,
    parse_chaos_plan,
    storm_plan,
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
    BrownoutLadder,
    BrownoutStage,
    QueueFull,
    Request,
    RequestHandle,
    ServeConfig,
    Server,
    generate_with_engine,
    parse_brownout_stages,
)
from distributeddeeplearning_tpu_torch.serving.fleet import (
    ControllerConfig,
    FleetConfig,
    FleetController,
    FleetHandle,
    Replica,
    Router,
    build_fleet,
)

__all__ = [
    "AdaptiveAdmissionPolicy",
    "AdmissionPolicy",
    "BlockAllocator",
    "BlockPoolExhausted",
    "BrownoutLadder",
    "BrownoutStage",
    "ChaosCrash",
    "ChaosInjector",
    "ControllerConfig",
    "DEFAULT_TOP_K_CAP",
    "FleetConfig",
    "FleetController",
    "FleetFault",
    "FleetHandle",
    "NgramDrafter",
    "PrefixDirectory",
    "ProgramSpec",
    "QueueFull",
    "Replica",
    "ReqSpec",
    "Request",
    "RequestHandle",
    "Router",
    "ServeConfig",
    "Server",
    "SlotEngine",
    "SpliceMismatch",
    "TRASH_BLOCK",
    "build_fleet",
    "default_buckets",
    "generate_with_engine",
    "hash_prefix_chain",
    "parse_brownout_stages",
    "parse_chaos_plan",
    "prompt_key",
    "request_key_ladder",
    "sample_slot",
    "sample_slots",
    "spec_verify_slots",
    "storm_plan",
]
