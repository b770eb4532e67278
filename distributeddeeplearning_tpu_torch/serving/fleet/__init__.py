"""Multi-replica serving fleet of the port: router, fairness,
streaming, disaggregated pools, autoscale (port of
``serving/fleet/``). N warmed engines behind one front door:

* :class:`~.replica.Replica` — one SlotEngine + Server on its own pump
  thread (and, on the card, its own CUDA stream) and its own event
  stream (``events-p0-s<k>.jsonl``), with a drain/fault lifecycle
  classified by the faults exit taxonomy.
* :class:`~.router.Router` — per-tenant deficit-weighted fair queueing,
  prefix-affinity/least-loaded placement, zero-drop drain and fault
  re-routing (splicing restarts on the per-request determinism
  contract), incremental token streaming, prefill/decode handoff, the
  prefix directory, live migration, the brownout ladder and the
  ``serve.fleet_pressure`` autoscale gauge.
* :class:`~.controller.FleetController` — consumes the pressure signal
  between ticks to add or drain replicas.

Driven by ``python -m distributeddeeplearning_tpu_torch.fleet_bench``
(and the ``disagg_bench`` / ``chaos_bench`` twins).
"""

from distributeddeeplearning_tpu_torch.serving.fleet.controller import (  # noqa: F401
    ControllerConfig,
    FleetController,
    PoolWatermarks,
)
from distributeddeeplearning_tpu_torch.serving.fleet.replica import (  # noqa: F401
    Replica,
)
from distributeddeeplearning_tpu_torch.serving.fleet.router import (  # noqa: F401
    DEFAULT_TENANT,
    FleetConfig,
    FleetHandle,
    Router,
    build_fleet,
    parse_tenant_weights,
)
