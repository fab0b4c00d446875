"""Gaussian noise-masking, the paper's robustness mechanism.

Port of ``snag_tpu/ops/noise.py`` (reference SNAG_MMEA/model/SNAG.py:66-99):
once per epoch, each feature-table row is selected w.p. ``noise_ratio`` and
blended with a sample of N(col_mean, col_std):
x' = (1 - mask_ratio) x + mask_ratio (mu + sigma eps).  Entity embeddings
get half rates inside the encoder forward (SNAG_tools.py:127-128).

``dropout`` (the GAT's and the fusion stack's) lives here too.  Under a
mesh a rank computes only its rows of a per-entity tensor; its
``RowSlice`` draws each dropout mask at the full row count and keeps its
own rows, so N ranks draw what one rank draws; a feature table's shard is
noised alike (``noise_mask_table``).
Randomness comes from explicit ``torch.Generator``s on the tensor's device,
seeded from (seed, epoch) by ``derive_seed``.  ``jax.random`` streams cannot
be reproduced, so the port matches the JAX package in distribution, not in
the drawn values.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from snag_tpu_torch.parallel.mesh import RowShard, Table


class TableStats(NamedTuple):
    mean: torch.Tensor  # (d,)
    std: torch.Tensor   # (d,)


def derive_seed(*ints: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative integers
    (distinct tuples give independent streams)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def table_stats(x: torch.Tensor,
                valid_rows: Optional[torch.Tensor] = None) -> TableStats:
    """Column mean/std; ``valid_rows`` restricts the statistics (the image
    table only counts entities that have an image, SNAG.py:77-80).  The
    variance divides by n - 1, torch.std's unbiased default."""
    if valid_rows is not None:
        x = x[valid_rows]
    mean = x.mean(dim=0)
    n = x.shape[0]
    var = torch.sum((x - mean) ** 2, dim=0) / max(n - 1, 1)
    return TableStats(mean=mean, std=torch.sqrt(var))


class RowSlice(NamedTuple):
    """A dropout generator for rows ``lo:hi`` of an ``n``-row tensor."""
    gen: torch.Generator
    lo: int
    hi: int
    n: int


def row_slice(gen: Optional[torch.Generator], lo: int, hi: int,
              n: int) -> Optional[RowSlice]:
    return None if gen is None else RowSlice(gen, lo, hi, n)


def keep_mask(shape, rate: float, gen, device) -> torch.Tensor:
    """A dropout keep mask, True w.p. 1 - rate, drawn from ``gen`` (a
    ``RowSlice``: drawn at its ``n`` rows, its own rows kept)."""
    if isinstance(gen, RowSlice):
        if shape[0] != gen.hi - gen.lo:
            raise ValueError(f"a mask of {shape[0]} rows for rows "
                             f"{gen.lo}:{gen.hi}")
        full = (gen.n,) + tuple(shape[1:])
        return (torch.rand(full, generator=gen.gen, device=device)
                >= rate)[gen.lo:gen.hi]
    return torch.rand(tuple(shape), generator=gen, device=device) >= rate


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``gen`` (flax
    ``nn.Dropout``: keep w.p. 1 - rate, scale kept values by 1/(1-rate));
    the identity when ``gen`` is None or the rate is 0."""
    if gen is None or rate <= 0.0:
        return x
    keep = keep_mask(x.shape, rate, gen, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def noise_mask_table(gen: torch.Generator, x: Table, stats: TableStats,
                     noise_ratio: float, mask_ratio: float) -> Table:
    """Row-masked Gaussian blend (add_noise_to_embeddings, SNAG.py:66-75).
    ``x`` may be a feature table's ``RowShard``: its draws are made at the
    whole table's shapes and its rows kept, so the noisy shard is rows
    ``lo:hi`` of the noisy whole table, bit for bit (the whole ``eps`` is
    a temporary)."""
    if isinstance(x, RowShard):
        return dataclasses.replace(x, local=_blend(
            gen, x.local, stats, noise_ratio, mask_ratio, (x.lo, x.hi, x.n)))
    return _blend(gen, x, stats, noise_ratio, mask_ratio)


def _blend(gen, x, stats, noise_ratio, mask_ratio, span=None):
    """``noise_mask_table`` of the tensor ``x``, or, with ``span`` = (lo,
    hi, n), of the rows lo:hi of an n-row table that ``x`` holds."""
    n = x.shape[0] if span is None else span[2]
    rows = torch.rand(n, generator=gen, device=x.device) < noise_ratio
    eps = torch.randn((n,) + tuple(x.shape[1:]), generator=gen,
                      device=x.device, dtype=x.dtype)
    if span is not None:
        rows, eps = rows[span[0]:span[1]], eps[span[0]:span[1]]
    noise = stats.mean + stats.std * eps
    blended = (1.0 - mask_ratio) * x + mask_ratio * noise
    return torch.where(rows[:, None], blended, x)


def entity_noise(gen: torch.Generator, emb: torch.Tensor, noise_ratio: float,
                 mask_ratio: float) -> torch.Tensor:
    """Entity-embedding noise at half rates (SNAG.py:94-98 +
    SNAG_tools.py:127-128); statistics over the current table, without
    gradient (the reference reads ``.weight.data``)."""
    return noise_mask_table(gen, emb, table_stats(emb.detach()),
                            noise_ratio * 0.5, mask_ratio * 0.5)
