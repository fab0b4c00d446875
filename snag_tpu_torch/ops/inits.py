"""Parameter initializers matching the reference's PyTorch defaults.

Port of ``snag_tpu/ops/inits.py`` against an explicit ``torch.Generator``:
the same distributions at the same (reference) fan-ins.  Each function
returns a new f32 CPU tensor; modules move to their device afterwards, so
one seed gives the same weights on every device.

Shapes follow torch's layout: a Linear weight is (out, in).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def uniform_stdv(shape: Sequence[int], stdv: float,
                 generator: torch.Generator) -> torch.Tensor:
    """U(-stdv, stdv) — GraphConvolution's reset_parameters (layers.py:118-122)."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return u * (2.0 * stdv) - stdv


def torch_linear(shape: Sequence[int], fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """torch ``nn.Linear`` default, kaiming-uniform(a=sqrt(5)) ==
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and bias, at an EXPLICIT
    fan-in: rel_fc's reference counterpart sees a 1000-column bag
    (src/data.py:521-538) however narrow our table is."""
    return uniform_stdv(shape, 1.0 / math.sqrt(fan_in), generator)


def normal_std(shape: Sequence[int], std: float,
               generator: torch.Generator) -> torch.Tensor:
    return std * torch.randn(tuple(shape), generator=generator,
                             dtype=torch.float32)


def xavier_normal_fan(shape: Sequence[int], fan_in: int,
                      generator: torch.Generator) -> torch.Tensor:
    """torch ``xavier_normal_`` of a Linear weight (out, in) at an EXPLICIT
    fan-in, N(0, 2 / (fan_in + out)): EVA's rel_fc draws at the reference's
    1000-column relation bag (EVA.py:43,55).  The bias of such a layer
    keeps ``torch_linear`` at the same fan-in (JAX ``torch_linear_bias``)."""
    return normal_std(shape, math.sqrt(2.0 / (fan_in + shape[0])), generator)


def xavier_normal(shape: Sequence[int],
                  generator: torch.Generator) -> torch.Tensor:
    """torch ``xavier_normal_`` of a 2-D tensor, N(0, 2 / (rows + cols)):
    EVA's entity table (EVA.py:53)."""
    return normal_std(shape, math.sqrt(2.0 / (shape[0] + shape[1])),
                      generator)
