"""tensorflowonspark_torch — the PyTorch / CUDA (H100) port of
``tensorflowonspark_tpu``.

The JAX package stays in the repository as the reference; this package
mirrors its module names and imports none of it.  Ported so far: the LM
serving replica — the node's feed (``feeding``), the bundle format
(``checkpoint``), the model registry and the decoder-only ``Transformer``
(``models``), the flash-attention forward as a hand-written Hopper kernel
(``ops.attention``, ``csrc/flash_attn_fwd.cu``) and the replica loop
(``serving.serving_loop``); LM training on one device — the attention's
recompute backward, the blockwise cross-entropy (``ops.xent``), the loss
(``models.transformer.make_loss_fn``) and the train step and batch feed
(``parallel.dp``); and the KV-cache decode path
(``models.transformer.greedy_generate``); and the cluster around them — the
coordinator, node processes, launchers, data plane and supervisor
(``run`` → ``TorchCluster``: ``train``, ``inference``, ``serve``) and the
online-serving gateway (``serving``: ``ServingGateway``, ``GatewayClient``);
and the image families of the BASELINE configs — the MNIST CNN, the ResNets
and Inception-v3 (``models.mnist``, ``models.resnet``,
``models.inception`` on the flax-semantics layers of ``models.layers``)
with the BatchNorm train step (``parallel.dp.make_bn_train_step``); and
BASELINE config 4 — wide-and-deep on Criteo (``models.wide_deep``, with
optax's Adagrad in ``optim``) through the ML pipeline (``pipeline``:
``TorchEstimator.fit`` → ``TorchModel.transform``), the cross-host
collective group behind ``train(mode="sync")`` (``collective``, reached as
``ctx.collective_group()``), and the sharded embedding tier
(``embedding``: range-sharded tables over the group's sparse collectives,
served through the gateway's lookup fan-out); and ``InputMode.DIRECT``
ingestion — the node-side reader pipeline, the data-service tier and
``ingest.device_prefetch`` (``ingest``), the autoscaler (``autoscale``) and
``torch.profiler`` traces (``profiling``).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"

import importlib

# The control plane (cluster, coordinator, node runtime, feeds, ingest) loads
# no torch: a node process registers without paying torch's import, as the
# JAX package's nodes skip jax's.  The names whose modules import torch load
# at first use (PEP 562).
from tensorflowonspark_torch import pipeline  # noqa: F401
from tensorflowonspark_torch import telemetry  # noqa: F401 - metrics/span API
from tensorflowonspark_torch import ingest  # noqa: F401 - DIRECT-mode reader pipeline
from tensorflowonspark_torch.cluster import InputMode, TorchCluster, run  # noqa: F401
from tensorflowonspark_torch.data import PartitionedDataset  # noqa: F401
from tensorflowonspark_torch.feeding import DataFeed, FeedQueues  # noqa: F401
from tensorflowonspark_torch.launcher import (  # noqa: F401
    LocalLauncher,
    SubprocessLauncher,
)
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition  # noqa: F401
from tensorflowonspark_torch.pipeline import (  # noqa: F401
    Namespace,
    TorchEstimator,
    TorchModel,
    TorchParams,
)

_LAZY = {
    "collective": ("tensorflowonspark_torch.collective", None),
    "export_bundle": ("tensorflowonspark_torch.checkpoint", "export_bundle"),
    "load_bundle": ("tensorflowonspark_torch.checkpoint", "load_bundle"),
    "load_bundle_cached": ("tensorflowonspark_torch.checkpoint",
                           "load_bundle_cached"),
    "bundle_inference_loop": ("tensorflowonspark_torch.inference",
                              "bundle_inference_loop"),
    "build": ("tensorflowonspark_torch.models.registry", "build"),
    "build_apply": ("tensorflowonspark_torch.models.registry", "build_apply"),
    "GatewayClient": ("tensorflowonspark_torch.serving", "GatewayClient"),
    "ServingGateway": ("tensorflowonspark_torch.serving", "ServingGateway"),
    "serving_loop": ("tensorflowonspark_torch.serving", "serving_loop"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    value = importlib.import_module(module)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


# drop-in aliases for TensorFlowOnSpark users, as in the JAX package
TFCluster = TorchCluster
TFEstimator = TorchEstimator
TFModel = TorchModel
TFParams = TorchParams
