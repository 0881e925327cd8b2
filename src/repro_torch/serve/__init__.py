"""Serving, in two modules that share nothing but the package.

* :mod:`repro_torch.serve.engine` serves the model: prefill and decode
  steps on one card (port of ``repro.serve.engine``).
* :mod:`repro_torch.serve.store_engine` serves store queries while
  ingest is live: ``CiaoServeEngine``, its write queues, snapshot
  readers and admission control (port of ``repro.serve.store_engine``).
"""
