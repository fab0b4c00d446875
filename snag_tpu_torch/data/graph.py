"""Graph preprocessing: triples -> row-sorted CSR edge list.

Port of ``snag_tpu/data/graph.py::build_graph`` with the same edge
multiset, normalisation and row sort (reference SNAG_MMEA/src/utils.py:327-362
``get_adjr`` + :220-226 ``normalize_adj``):

* undirected multiplicity-weighted adjacency: every (h, t) triple pair with
  h != t contributes its multiplicity in both directions;
* self-loops with weight 1 on every node;
* symmetric normalisation D^-1/2 A D^-1/2.

The JAX package pads the edge list to a static capacity and builds tile
and spill structures for its TPU grid.  Here the kernels walk
``row_ptr`` directly, so only the real edges are kept and nothing is
padded.

``rev``, recorded at build time, pairs every edge with its reverse
(``row[rev[k]] == col[k]``, ``col[rev[k]] == row[k]``); it exists exactly
when the (row, col) edge multiset equals the (col, row) multiset, which
``symmetric`` reports.  On such a graph every in-edge of a node is one of
its out-edges reversed, so a reduction over a node's in-edges is one over
its CSR row: the GAT backward kernel relies on it
(snag_tpu/ops/pallas/gat_bwd.py:17-32) and refuses a graph without it, and
the backward of the weighted segment sum (``ops/gat_agg.py``) walks rows
with the weights ``e[rev]``; for the GCN's e, the adjacency itself, those
are ``DeviceGraph.w_rev``, gathered once when the graph is moved, as are
the bf16 copies of both (``w_bf16``, ``w_rev_bf16``) that the GCN takes
under ``--dtype bfloat16``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceGraph(NamedTuple):
    """The graph's tensors on one device, as the GAT wrappers read them."""
    n_nodes: int
    n_edges: int
    row_ptr: torch.Tensor   # (N+1,) int32
    row: torch.Tensor       # (E,) int64, sorted ascending
    col: torch.Tensor       # (E,) int32
    w: torch.Tensor         # (E,) f32, sym-normalised adjacency values
    rev: Optional[torch.Tensor]   # (E,) int64 reverse edge, None if asymmetric
    w_rev: Optional[torch.Tensor] = None   # (E,) f32 w[rev], with rev
    w_bf16: Optional[torch.Tensor] = None      # (E,) w rounded to bf16
    w_rev_bf16: Optional[torch.Tensor] = None  # (E,) w_rev rounded to bf16

    @property
    def symmetric(self) -> bool:
        """(row, col) multiset == (col, row) multiset."""
        return self.rev is not None


@dataclass
class Graph:
    """Row-sorted edge list with CSR row pointers.

    ``out[i] = sum over e in [row_ptr[i], row_ptr[i+1]) of w[e] * h[col[e]]``.
    """

    n_nodes: int
    n_edges: int          # self-loops included
    row: np.ndarray       # (E,) int32, sorted ascending
    col: np.ndarray       # (E,) int32
    w: np.ndarray         # (E,) float32, sym-normalised
    mask: np.ndarray      # (E,) bool, all True (no padding)
    row_ptr: np.ndarray   # (N+1,) int32
    rev: Optional[np.ndarray] = None   # (E,) int64, when symmetric

    @property
    def symmetric(self) -> bool:
        """(row, col) multiset == (col, row) multiset."""
        return self.rev is not None

    def to_torch(self, device) -> DeviceGraph:
        w = torch.as_tensor(self.w, device=device)
        w_rev = (None if self.rev is None
                 else torch.as_tensor(self.w[self.rev], device=device))
        return DeviceGraph(
            n_nodes=self.n_nodes, n_edges=self.n_edges,
            row_ptr=torch.as_tensor(self.row_ptr, device=device),
            row=torch.as_tensor(self.row.astype(np.int64), device=device),
            col=torch.as_tensor(self.col, device=device),
            w=w,
            rev=None if self.rev is None
            else torch.as_tensor(self.rev, device=device),
            w_rev=w_rev, w_bf16=w.to(torch.bfloat16),
            w_rev_bf16=None if w_rev is None else w_rev.to(torch.bfloat16))


def is_symmetric(n_nodes: int, rows: np.ndarray, cols: np.ndarray) -> bool:
    """True when the (row, col) multiset equals the (col, row) multiset."""
    return reverse_edges(n_nodes, rows, cols) is not None


def reverse_edges(n_nodes: int, rows: np.ndarray,
                  cols: np.ndarray) -> Optional[np.ndarray]:
    """rev (E,) int64 with (row, col)[rev[k]] == (col, row)[k], or None
    when the (row, col) multiset differs from the (col, row) multiset."""
    fwd_key = rows.astype(np.int64) * n_nodes + cols
    rev_key = cols.astype(np.int64) * n_nodes + rows
    by_fwd = np.argsort(fwd_key, kind="stable")
    by_rev = np.argsort(rev_key, kind="stable")
    if not np.array_equal(fwd_key[by_fwd], rev_key[by_rev]):
        return None
    rev = np.empty(rows.shape[0], dtype=np.int64)
    rev[by_rev] = by_fwd
    return rev


def build_graph(n_nodes: int,
                triples: Sequence[Tuple[int, int, int]]) -> Graph:
    """Build the normalised, row-sorted edge list from raw triples."""
    # multiplicity-weighted undirected pairs, h != t (get_adjr), keyed
    # UNDIRECTED so each direction appears once with the summed count
    pairs = {}
    for h, _, t in triples:
        if h == t:
            continue
        key = (int(h), int(t)) if h <= t else (int(t), int(h))
        pairs[key] = pairs.get(key, 0) + 1

    n_real = 2 * len(pairs) + n_nodes
    rows = np.empty(n_real, dtype=np.int64)
    cols = np.empty(n_real, dtype=np.int64)
    vals = np.empty(n_real, dtype=np.float64)
    i = 0
    for (h, t), c in pairs.items():
        rows[i], cols[i], vals[i] = h, t, c
        rows[i + 1], cols[i + 1], vals[i + 1] = t, h, c
        i += 2
    rows[i:] = np.arange(n_nodes)
    cols[i:] = np.arange(n_nodes)
    vals[i:] = 1.0

    deg = np.zeros(n_nodes, dtype=np.float64)
    np.add.at(deg, rows, vals)
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -0.5)
    dinv[np.isinf(dinv)] = 0.0
    norm_vals = vals * dinv[rows] * dinv[cols]

    order = np.argsort(rows, kind="stable")
    rows, cols, norm_vals = rows[order], cols[order], norm_vals[order]

    if np.unique(rows).size != n_nodes:
        raise ValueError("graph rows must cover every node (self-loops missing?)")

    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=n_nodes))
    if row_ptr[-1] != n_real:
        raise ValueError(f"row_ptr[-1] = {row_ptr[-1]} != n_edges = {n_real}")
    if n_real >= 2 ** 31:
        raise ValueError(f"{n_real} edges overflow the int32 CSR indices")
    return Graph(n_nodes=n_nodes, n_edges=n_real,
                 row=rows.astype(np.int32), col=cols.astype(np.int32),
                 w=norm_vals.astype(np.float32),
                 mask=np.ones(n_real, dtype=bool),
                 row_ptr=row_ptr.astype(np.int32),
                 rev=reverse_edges(n_nodes, rows, cols))
