"""Parameters of the JAX package in the port's layout.

``params_from_reference`` takes the JAX package's split parameter values
as a nested dict of numpy arrays (``jax.tree.map(np.asarray, values)``),
each layer group stacked on its leading ``layers`` axis, and returns the
port's parameters on ``device``.  The layouts are the same, so the
conversion checks every name and shape against the configuration and
copies; the CPU tests use it to make both packages compute the same
thing.  It imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from . import transformer


def params_from_reference(values: dict, cfg, device="cpu") -> dict:
    """The JAX package's parameter values as the port's tensors."""
    want = transformer.param_shapes(cfg)
    dev = torch.device(device)

    def walk(got, shapes, path: str):
        if set(got) != set(shapes):
            raise ValueError(f"{path or 'params'}: keys {sorted(got)} != "
                             f"{sorted(shapes)}")
        out = {}
        for k, shape in shapes.items():
            sub = f"{path}/{k}" if path else k
            if isinstance(shape, dict):
                if not isinstance(got[k], dict):
                    raise ValueError(f"{sub}: expected a dict")
                out[k] = walk(got[k], shape, sub)
                continue
            a = np.asarray(got[k])
            if a.shape != shape:
                raise ValueError(f"{sub}: shape {a.shape} != {shape}")
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return out

    return walk(values, want, "")
