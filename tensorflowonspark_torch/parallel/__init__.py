"""Training steps and their data feed — counterpart of
``tensorflowonspark_tpu/parallel``.  Ported so far: ``dp`` on one device
(``mesh``, ``tp``, ``sp``, ``ep`` and ``pp`` wait for ROADMAP.md queue 1 (e))."""
