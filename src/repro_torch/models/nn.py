"""Parameter tree and initializer: torch counterpart of `repro.models.nn`.

A parameter tree is a tree of `Params` modules whose attribute names are
the JAX package's dict keys, so `model.named_parameters()` lists
`units.3.b0.mixer.wq` where JAX has `params["units"]["b0"]["mixer"]["wq"]`
stacked on a leading layer axis (entry 3). Model code reads a node as
`p["wq"]`, as the JAX functions read their dicts. Parameters never take
gradients: this slice serves, it does not train.

`Initializer` draws every parameter from one explicit `torch.Generator`
with the distributions of `repro.models.nn.Initializer`. The numbers differ
from JAX's (another generator); tests carry JAX's values across with
`repro_torch.testing.params_from_jax`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


class Params(torch.nn.Module):
    """One node of the parameter tree; `p[name]` reads a child or a
    parameter."""

    def __getitem__(self, name: str):
        return getattr(self, name)


class Initializer:
    """Adds parameters to `module`, drawing from `generator` on its device."""

    def __init__(self, module: Params, generator: torch.Generator,
                 param_dtype=torch.float32):
        self.module = module
        self.generator = generator
        self.param_dtype = param_dtype

    def scope(self, name: str) -> "Initializer":
        child = Params()
        self.module.add_module(name, child)
        return Initializer(child, self.generator, self.param_dtype)

    def _normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.generator.device,
                           dtype=torch.float32) * std

    def param(self, name: str, shape: Tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None, dtype=None) -> torch.Tensor:
        dtype = dtype or self.param_dtype
        dev = self.generator.device
        if init == "zeros":
            v = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "ones":
            v = torch.ones(shape, dtype=dtype, device=dev)
        elif init == "normal":
            v = self._normal(shape, scale if scale is not None else 0.02)
        elif init == "fan_in":
            fan_in = shape[0] if len(shape) >= 1 else 1
            v = self._normal(shape, 1.0 / math.sqrt(max(fan_in, 1)))
        elif init == "uniform":
            s = scale if scale is not None else 1.0
            v = torch.rand(shape, generator=self.generator, device=dev,
                           dtype=torch.float32) * (2 * s) - s
        else:
            raise ValueError(init)
        p = torch.nn.Parameter(v.to(dtype), requires_grad=False)
        self.module.register_parameter(name, p)
        return p


def count_params(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
