"""Serving protocol constants shared by the gateway side and ``serving_loop``
— the part of ``tensorflowonspark_tpu/serving/batcher.py`` the replica loop
needs.  The dynamic batcher itself comes with the gateway."""

#: Marker key for in-band control items on the serving stream (reload /
#: ping); ``serving_loop`` answers each with a one-item ack, preserving the
#: exactly-count invariant of the transport.
CTL_KEY = "_tos_serve_ctl"
