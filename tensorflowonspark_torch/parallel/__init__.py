"""Training steps, their data feed and the device mesh — counterpart of
``tensorflowonspark_tpu/parallel``: ``dp`` (train steps, over a mesh too),
``mesh`` (a ``DeviceMesh`` named by ``AXES``), ``tp`` (Megatron layouts and
their collectives, ``shard_model``), ``sp`` (ring and Ulysses attention) and
``ep`` (the MoE FFN).  ``pp`` is not ported yet (ROADMAP.md queue 1 (l))."""
