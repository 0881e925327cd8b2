"""Distributed-execution support (port of ``repro.dist``).

Only ``collectives.tree_reduce`` is ported: the sharded store plane's
deterministic merge.  The model mesh (``repro.dist.sharding``,
``compressed_allreduce``, the flash-decoding sharded attention) is not
ported yet; see ``collectives``.
"""
from . import collectives  # noqa: F401
