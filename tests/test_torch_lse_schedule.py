"""The work schedule of the lse kernels, emulated in plain torch.

``csrc/gram_lse.cuh`` (``mixture_lse`` and ``ntxent_lse``) computes each
element of a symmetric channel once: the n2 rows are cut into tiles, a
block takes one unordered pair of tiles (I <= J), decoded from its linear
index by ``lse::tile_pair`` in float32, and adds every exp to its row's
sum and, off the diagonal pair, to its column's.  Row partials go to
part[ch][J][rows of I], column partials to part[ch][I][rows of J]; a
second kernel adds part over t in order.  Here that schedule runs in f64
with small tiles, checking that every slot is written exactly once and
that the result is the twins' (``streaming_lse_twin``,
``mixture_lse_twin``) within 1e-6: ragged tiles, n2 smaller than a tile,
invalid columns, an all-zero row, one to six modalities.

The bf16 kernel (``csrc/gram_lse_bf16.cuh``, ``mixture_lse_bf16`` and
``ntxent_lse_bf16``) splits the same work among persistent blocks: the
work index w = batch x pairs + pair (NT-Xent; the mixture's w is the pair,
every modality over it) runs from 0 to its end, block b of G walks
[work b / G, work (b + 1) / G), pair by pair, and writes the same slots.
``scheduled_lse`` takes the block count, so the tests also hold that walk
(the plan's G = min(work, SMs x blocks per SM)): every slot once, the
twins within 1e-6.  Its K order is the f32 kernel's (each k16 slice from
zero, added in fp32 in increasing k), so the bf16 mma schedule of
tests/test_torch_bf16.py holds it unchanged.
"""

import numpy as np
import pytest
import torch

from snag_tpu_torch.ops.cuda import ntxent as tnx
from snag_tpu_torch.ops.cuda import snag_loss as tsl
from torch_port_common import single_thread

single_thread()
TAU = 0.1


def tile_pair(p: np.ndarray, n: int):
    """``lse::tile_pair``: the pair (I, J), I <= J, of linear index p over
    the upper triangle of an n x n tile grid, row by row; the first guess
    in float32 as the kernel takes it, then its integer fix-ups."""
    def first(i):
        return i * n - i * (i - 1) // 2
    b = np.float32(2 * n + 1)
    disc = np.maximum(b * b - np.float32(8) * p.astype(np.float32),
                      np.float32(0))
    i = (np.float32(0.5) * (b - np.sqrt(disc))).astype(np.int64)
    i = np.clip(i, 0, n - 1)
    while (down := (i > 0) & (first(i) > p)).any():
        i[down] -= 1
    while (up := (i + 1 < n) & (first(i + 1) <= p)).any():
        i[up] += 1
    return i, i + p - first(i)


def _padded(x: torch.Tensor, start: int, tile: int, dim: int):
    """Rows [start, start + tile) of x along dim, zero past its end (the
    kernel's zero fill)."""
    part = x.narrow(dim, start, min(tile, x.shape[dim] - start))
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, tile - part.shape[dim]]
    return torch.nn.functional.pad(part, pad)


def persistent_runs(work: int, blocks: int):
    """The bf16 kernel's split of the work index among ``blocks``
    persistent blocks: block b walks [work b / G, work (b + 1) / G)."""
    return [range(work * b // blocks, work * (b + 1) // blocks)
            for b in range(blocks)]


def scheduled_lse(z, v, tau, tile, alpha=None, beta=None, blocks=None):
    """The lse kernels' schedule: NT-Xent channels are z's batches; with
    alpha and beta the mixture's [K_0 .. K_{M-1} | mix_a | mix_f].  With
    ``blocks``, the bf16 kernel's persistent walk: NT-Xent's work w is
    batch w // pairs, pair w % pairs; otherwise (the f32 kernel) a block
    a pair, every batch at once."""
    inv_tau = 1.0 / tau
    m, n2, _ = z.shape
    tiles = -(-n2 // tile)
    pairs = tiles * (tiles + 1) // 2
    channels = m if alpha is None else m + 2
    part = torch.full((channels, tiles, n2), float("nan"), dtype=z.dtype)
    writes = torch.zeros(channels, tiles, n2, dtype=torch.int64)
    off_diag = 1.0 - torch.eye(tile, dtype=z.dtype)
    if blocks is None:
        walk = [(None, p) for p in range(pairs)]
    else:
        reps = m if alpha is None else 1
        walk = [(w // pairs if alpha is None else None, w % pairs)
                for run in persistent_runs(pairs * reps, blocks)
                for w in run]
    for batch, p in walk:
        i, j = (int(x[0]) for x in tile_pair(np.array([p]), tiles))
        r0, c0 = i * tile, j * tile
        nr, nc = min(tile, n2 - r0), min(tile, n2 - c0)
        zb = z if batch is None else z[batch:batch + 1]
        k = torch.einsum("mrd,mcd->mrc", _padded(zb, r0, tile, 1),
                         _padded(zb, c0, tile, 1))
        vr, vc = _padded(v, r0, tile, 0), _padded(v, c0, tile, 0)
        chans = list(enumerate(k)) if batch is None else [(batch, k[0])]
        if alpha is not None:
            ar, ac = _padded(alpha, r0, tile, 0), _padded(alpha, c0, tile, 0)
            chans += [(m, torch.einsum("rm,cm,mrc->rc", ar, ac, k)),
                      (m + 1, torch.einsum("m,mrc->rc", beta, k))]
        for ch, x in chans:
            e = torch.exp(x * inv_tau - inv_tau)
            if i == j:
                e = e * off_diag
            part[ch, j, r0:r0 + nr] = (e * vc[None, :]).sum(dim=1)[:nr]
            writes[ch, j, r0:r0 + nr] += 1
            if i < j:
                part[ch, i, c0:c0 + nc] = (e * vr[:, None]).sum(dim=0)[:nc]
                writes[ch, i, c0:c0 + nc] += 1
    assert bool((writes == 1).all()), "a partial slot written twice or never"
    return torch.log(part.sum(dim=1) + tnx.LSE_EPS) + inv_tau


def _inputs(m, b, d, n_valid, seed):
    """f64 unit rows with near-copy positives and one all-zero row,
    validity of the first n_valid pairs, unit mixture coefficients."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d))
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[m - 1, 1] = 0.0
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float64)
    alpha = np.abs(rng.normal(size=(2 * b, m)))
    alpha /= np.linalg.norm(alpha, axis=1, keepdims=True)
    u = rng.uniform(0.2, 1.0, size=m)
    beta = u * u / np.sum(u * u)
    return [torch.from_numpy(a) for a in (z, v, alpha, beta)]


@pytest.mark.parametrize("n", [1, 2, 7, 55, 110, 1000, 4096])
def test_tile_pairs_cover_the_upper_triangle_once(n):
    p = np.arange(n * (n + 1) // 2)
    i, j = tile_pair(p, n)
    assert ((0 <= i) & (i <= j) & (j < n)).all()
    # row by row: the index is recovered, so no pair repeats or is missed
    assert (i * n - i * (i - 1) // 2 + j - i == p).all()
    assert (np.diff(i) >= 0).all()


# (M, B, d, valid pairs, tile): ragged last tiles, n2 a multiple of the
# tile, n2 smaller than one tile, invalid columns
NTXENT_CASES = [(2, 10, 8, 10, 8), (1, 3, 5, 3, 16), (3, 17, 12, 11, 8),
                (2, 16, 8, 16, 8)]


@pytest.mark.parametrize("m,b,d,n_valid,tile", NTXENT_CASES, ids=str)
def test_ntxent_schedule_is_the_twin(m, b, d, n_valid, tile):
    z, v, _, _ = _inputs(m, b, d, n_valid, seed=b)
    got = scheduled_lse(z, v, TAU, tile)
    want = tnx.streaming_lse_twin(z, v, TAU)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)


# M = 1 .. 6, the same edge cases
MIXTURE_CASES = [(1, 9, 6, 9, 8), (2, 13, 7, 10, 8), (3, 20, 5, 20, 16),
                 (4, 12, 6, 7, 8), (5, 4, 6, 4, 16), (6, 21, 9, 15, 8)]


@pytest.mark.parametrize("m,b,d,n_valid,tile", MIXTURE_CASES, ids=str)
def test_mixture_schedule_is_the_twin(m, b, d, n_valid, tile):
    z, v, alpha, beta = _inputs(m, b, d, n_valid, seed=b)
    got = scheduled_lse(z, v, TAU, tile, alpha, beta)
    want = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)


# (M, B, d, valid pairs, tile, blocks): fewer blocks than work, one block,
# as many blocks as work (the plan's bound), runs that cross a batch
BF16_NTXENT_CASES = [(2, 10, 8, 10, 8, 4), (1, 3, 5, 3, 16, 1),
                     (3, 17, 12, 11, 8, 7), (2, 16, 8, 16, 8, 20)]


@pytest.mark.parametrize("m,b,d,n_valid,tile,blocks", BF16_NTXENT_CASES,
                         ids=str)
def test_ntxent_persistent_walk_is_the_twin(m, b, d, n_valid, tile, blocks):
    z, v, _, _ = _inputs(m, b, d, n_valid, seed=b)
    got = scheduled_lse(z, v, TAU, tile, blocks=blocks)
    want = tnx.streaming_lse_twin(z, v, TAU)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)


BF16_MIXTURE_CASES = [(1, 9, 6, 9, 8, 2), (4, 12, 6, 7, 8, 3),
                      (5, 4, 6, 4, 16, 1), (6, 21, 9, 15, 8, 6)]


@pytest.mark.parametrize("m,b,d,n_valid,tile,blocks", BF16_MIXTURE_CASES,
                         ids=str)
def test_mixture_persistent_walk_is_the_twin(m, b, d, n_valid, tile, blocks):
    z, v, alpha, beta = _inputs(m, b, d, n_valid, seed=b)
    got = scheduled_lse(z, v, TAU, tile, alpha, beta, blocks=blocks)
    want = tsl.mixture_lse_twin(z, alpha, beta, v, TAU)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("work,blocks", [(1540 * 4, 264), (1540, 132),
                                         (7, 7), (10, 3)])
def test_persistent_runs_cover_the_work_once(work, blocks):
    """Runs are contiguous, in order, cover [0, work) once, and differ in
    length by at most one."""
    runs = persistent_runs(work, blocks)
    flat = [w for r in runs for w in r]
    assert flat == list(range(work))
    assert max(map(len, runs)) - min(map(len, runs)) <= 1
