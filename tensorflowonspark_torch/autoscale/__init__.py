"""Elastic autoscaling: the policy half of ``cluster.resize``.

The mechanism (grow/shrink/rebalance a live cluster) lives in
``cluster.TorchCluster.resize``; this package supplies what drives it:

- :mod:`~tensorflowonspark_torch.autoscale.policy` — pure stats->count
  policies (:class:`QueueDepthBandPolicy`, :class:`LatencyCeilingPolicy`,
  :class:`RowsPerNodeFloorPolicy`, the data-service tier's
  :class:`IngestBacklogPolicy`) and the anti-flap
  :class:`HysteresisGovernor`;
- :mod:`~tensorflowonspark_torch.autoscale.loop` — the
  :class:`Autoscaler` thread composing them over a live cluster
  (``cluster.autoscale(...)`` starts one).
"""

from tensorflowonspark_torch.autoscale.loop import Autoscaler
from tensorflowonspark_torch.autoscale.policy import (
    HysteresisGovernor,
    IngestBacklogPolicy,
    LatencyCeilingPolicy,
    Policy,
    QueueDepthBandPolicy,
    RowsPerNodeFloorPolicy,
)

__all__ = [
    "Autoscaler",
    "HysteresisGovernor",
    "IngestBacklogPolicy",
    "LatencyCeilingPolicy",
    "Policy",
    "QueueDepthBandPolicy",
    "RowsPerNodeFloorPolicy",
]
