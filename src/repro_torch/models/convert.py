"""Parameters and optimizer state of the JAX package in the port's layout.

``params_from_reference`` takes the JAX package's split parameter values
as a nested dict of numpy arrays (``jax.tree.map(np.asarray, values)``),
each layer group stacked on its leading ``layers`` axis, and returns the
port's parameters on ``device``.  ``opt_state_from_reference`` does the
same for an optimizer state of ``repro.train.optimizer`` (AdamW's ``m``,
``v`` and ``step``, adafactor's ``f`` and ``step``, and the train step's
``ef``).  The layouts are the same, so the conversion checks every name
and shape against the configuration and copies; the CPU tests use it to
start both packages from one state.  Both default to the card, as every
entry point of the port.  It imports neither ``jax`` nor the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import resolve_device
from .model import family_module


def params_from_reference(values: dict, cfg, device="cuda") -> dict:
    """The JAX package's parameter values as the port's tensors: every
    family's tree (decoder groups, the hybrid's ``rec`` and ``attn``
    blocks, RWKV's ``tm``/``cm``, encdec's ``enc``/``dec`` stacks)."""
    return _convert(values, family_module(cfg).param_shapes(cfg),
                    resolve_device(device))


def opt_state_from_reference(state: dict, cfg, device="cuda") -> dict:
    """A JAX optimizer state (numpy leaves) as the port's tensors: the
    moment trees checked against the parameters' shapes, ``step`` a 0-d
    int32 tensor."""
    dev = resolve_device(device)
    shapes = family_module(cfg).param_shapes(cfg)
    allowed = {"m", "v", "f", "ef", "step"}
    if not set(state) <= allowed or "step" not in state:
        raise ValueError(f"optimizer state keys {sorted(state)}: expected "
                         f"'step' and some of {sorted(allowed - {'step'})}")
    out = {"step": torch.from_numpy(
        np.array(state["step"], dtype=np.int32)).to(dev)}
    for k in ("m", "v", "ef"):
        if k in state:
            out[k] = _convert(state[k], shapes, dev, k)
    if "f" in state:
        out["f"] = _convert(state["f"], _factored_shapes(shapes), dev, "f")
    return out


def _factored_shapes(shapes):
    """adafactor's state shapes for a tree of parameter shapes."""
    if isinstance(shapes, dict):
        return {k: _factored_shapes(v) for k, v in shapes.items()}
    if len(shapes) >= 2:
        return {"vr": shapes[:-1], "vc": shapes[:-2] + shapes[-1:]}
    return {"v": shapes}


def _convert(values: dict, want: dict, dev: torch.device,
             root: str = "") -> dict:
    """``values`` (numpy leaves) as tensors on ``dev``, every key and shape
    checked against ``want``."""

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
            # a copy: the port updates parameters in place
            out[k] = torch.from_numpy(np.array(a)).to(dev)
        return out

    return walk(values, want, root)
