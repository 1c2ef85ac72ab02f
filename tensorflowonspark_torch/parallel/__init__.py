"""Training steps, their data feed and the device mesh — counterpart of
``tensorflowonspark_tpu/parallel``: ``dp`` (train steps, over a mesh too),
``mesh`` (a ``DeviceMesh`` named by ``AXES``), ``tp`` (Megatron layouts and
their collectives, ``shard_model``), ``sp`` (ring and Ulysses attention),
``ep`` (the MoE FFN) and ``pp`` (GPipe and 1F1B pipelines)."""

from tensorflowonspark_torch.parallel.pp import (  # noqa: F401
    gpipe,
    pipeline_1f1b,
    stack_stages,
    stage_shardings,
)
