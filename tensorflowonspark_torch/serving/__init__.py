"""tensorflowonspark_torch.serving — low-latency online inference gateway.

The request/response subsystem layered on the existing cluster (the batch
stack's missing half — see ``gateway.py`` for the architecture):

- :class:`ServingGateway` — driver-side handle (``cluster.serve``);
- :class:`ReactorFrontend` — the single-thread ``selectors`` reactor TCP
  endpoint: pipelined multiplexed connections, zero-copy out-of-order
  responses, fast-fail backpressure (``frontend.py``);
- :class:`GatewayClient` / :class:`GatewayClientPool` — the pipelined
  remote caller (many id-tagged requests outstanding per socket) and a
  connection pool for closed-loop caller fleets;
- :class:`MicroBatcher` — dynamic micro-batching + admission control
  (per-tenant weighted DRR queues, token-bucket rate limits, and the
  brownout shed ladder — ``tenancy.py``);
- :class:`ReplicaRouter` — least-outstanding routing, death retry,
  incarnation-fenced recovery, cohort-split rollout routing;
- :class:`RolloutGovernor` — shadow/canary staged rollouts with
  auto-promote / auto-rollback (``gateway.rollout``, ``rollout.py``);
- :func:`serving_loop` — the resident node map_fun.

Tuning knobs: ``TOS_SERVE_QUEUE``, ``TOS_SERVE_MAX_BATCH``,
``TOS_SERVE_MAX_DELAY_MS``, ``TOS_SERVE_TIMEOUT``,
``TOS_SERVE_HANDSHAKE_TIMEOUT``, ``TOS_SERVE_CONN_OUTSTANDING``,
``TOS_SERVE_CANARY_PCT``, ``TOS_SERVE_ROLLOUT_WINDOW_SECS``,
``TOS_SERVE_TENANT_RATE``, ``TOS_SERVE_SHED_LADDER`` (see the README
table).
"""

from tensorflowonspark_torch.serving.batcher import (  # noqa: F401
    MicroBatch,
    MicroBatcher,
    PendingPrediction,
    ServeClosed,
    ServeQueueFull,
    ServeThrottled,
    ServeTimeout,
)
from tensorflowonspark_torch.serving.frontend import ReactorFrontend  # noqa: F401
from tensorflowonspark_torch.serving.gateway import (  # noqa: F401
    CTL_KEY,
    GatewayClient,
    GatewayClientPool,
    LegacyGatewayClient,
    ServingGateway,
)
from tensorflowonspark_torch.serving.loop import serving_loop  # noqa: F401
from tensorflowonspark_torch.serving.rollout import (  # noqa: F401
    RolloutGovernor,
    RolloutState,
)
from tensorflowonspark_torch.serving.router import ReplicaRouter  # noqa: F401
from tensorflowonspark_torch.serving.tenancy import TenantQueues  # noqa: F401
