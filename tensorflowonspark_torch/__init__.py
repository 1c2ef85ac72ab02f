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
online-serving gateway (``serving``: ``ServingGateway``, ``GatewayClient``).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"

from tensorflowonspark_torch import telemetry  # noqa: F401 - metrics/span API
from tensorflowonspark_torch.cluster import InputMode, TorchCluster, run  # noqa: F401
from tensorflowonspark_torch.checkpoint import (  # noqa: F401
    export_bundle,
    load_bundle,
    load_bundle_cached,
)
from tensorflowonspark_torch.data import PartitionedDataset  # noqa: F401
from tensorflowonspark_torch.feeding import DataFeed, FeedQueues  # noqa: F401
from tensorflowonspark_torch.inference import bundle_inference_loop  # noqa: F401
from tensorflowonspark_torch.launcher import (  # noqa: F401
    LocalLauncher,
    SubprocessLauncher,
)
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition  # noqa: F401
from tensorflowonspark_torch.models.registry import build, build_apply  # noqa: F401
from tensorflowonspark_torch.serving import (  # noqa: F401
    GatewayClient,
    ServingGateway,
    serving_loop,
)
TFCluster = TorchCluster  # drop-in alias for TensorFlowOnSpark users, as in the JAX package
