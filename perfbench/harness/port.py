"""The program's optimizer configuration, built from a configuration file.

The port trains with an ``OptConfig``; this module fills it from the
file's ``run.optimizer``, so the optimizer that is run is the one the file
states.  Each architecture's ``ModelConfig`` is built by its adapter in
:mod:`perfbench.harness.ports`.
"""
from __future__ import annotations

from repro_torch.train.optimizer import OptConfig


def opt_config(conf: dict) -> OptConfig:
    o = conf["run"]["optimizer"]
    return OptConfig(kind=o["kind"], learning_rate=o["learning_rate"], b1=o["b1"],
                     b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                     grad_clip=o["grad_clip"], opt_dtype=conf["run"]["param_dtype"],
                     warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                     min_lr_frac=o["min_lr_frac"])
