"""The analysis plane (port of ``repro.analysis``).

  * flops    — the analytic FLOPs / HBM-bytes model of every config and
    of one device scan launch (a copy of the JAX package's)
  * roofline — compute, memory and collective terms at the H100's
    constants
  * comms    — the collectives one step issues, recorded as it runs (the
    role of the JAX package's ``hlo.py``; there is no HLO to parse)
"""
