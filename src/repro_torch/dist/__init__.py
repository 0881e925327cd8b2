"""Distributed-execution support (port of ``repro.dist``): logical-axis
sharding rules over a ``DeviceMesh`` (``sharding``) and the reduction
primitives (``collectives``: ``tree_reduce``, ``compressed_allreduce``,
and the JAX package's flash-decoding stub).
"""
from . import collectives, sharding  # noqa: F401
