"""Multi-GPU runtime: ``--mesh_shape data:N`` over ``torch.distributed``.

Port of ``snag_tpu/parallel/mesh.py``: one process per GPU (a rank), NCCL
between cards and gloo on the CPU.  Every rank loads the same KG from the
same seed; what the ranks split is the per-entity work (``Mesh.rows`` /
``gather_rows``, used by the MMEA encoders), the evaluation's query rows
(``eval/sharded.py``), the IL mining's left candidates (``train/il.py``)
and MKGC's batch rows and evaluation chunks.  Parameters are replicated
and ``all_reduce_mean`` averages their gradients before each optimizer
update, as XLA's psum sums them under the JAX mesh.

The feature tables are placed by entity, as the JAX package's
``shard_kg_arrays`` places them: under N > 1 ranks each rank keeps only
its ``Mesh.rows`` share of every table (``RowShard``, ``shard_table``),
the rows that every per-entity forward over all entities reads there, and
fetches any other row from its owner (``take_rows``: one plan for every
table of a forward, one all-gather of the request counts, and, where a
rank asks another for rows, one ``all_to_all_single`` of those ids and
one of all the tables' rows).  The edge arrays stay whole on every
rank, where the structure encoder runs whole.

Every collective of the port goes through a ``Mesh`` here.  Under gloo
they run on host copies of the tensors: gloo reduces CUDA tensors but
cannot all-gather them, so two ranks sharing one card (which NCCL refuses)
go through host memory, and ``make_mesh`` logs it.  NCCL is used on the
card unless the caller asks for gloo.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# a rank that fails leaves the others waiting in a collective at most this
# long before they raise
TIMEOUT_S = 600


def discover_distributed_env(environ=None):
    """(coordinator_address, num_processes, process_id) from the process
    environment, or (None, None, None) for a single process: explicit
    ``JAX_*`` variables first, then torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``, then SLURM's (the JAX package's
    order and names, reference src/distributed_utils.py:15-21)."""
    env = os.environ if environ is None else environ

    addr = env.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        n = env.get("JAX_NUM_PROCESSES")
        pid = env.get("JAX_PROCESS_ID")
        return (addr, int(n) if n else None, int(pid) if pid else None)

    if "RANK" in env and "WORLD_SIZE" in env:
        host = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT", "12355")
        return (f"{host}:{port}", int(env["WORLD_SIZE"]), int(env["RANK"]))

    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = nodelist.split(",")[0].split("[")[0] if nodelist else "127.0.0.1"
        port = env.get("MASTER_PORT", "12355")
        return (f"{head}:{port}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]))

    return (None, None, None)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(backend: Optional[str] = None,
                           device: str = "cuda",
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout_s: float = TIMEOUT_S) -> bool:
    """Join a process group: the one ``init_method`` / ``rank`` /
    ``world_size`` name, else the one the environment names
    (``discover_distributed_env``; torchrun's through ``env://``).
    ``backend`` defaults to NCCL for a ``cuda`` device and gloo for the
    CPU.  Returns False where there is no group to join (one process),
    True where this process is in one."""
    if dist.is_initialized():
        return True
    if init_method is None:
        addr, world_size, rank = discover_distributed_env()
        if addr is None:
            return False
        env = os.environ
        init_method = ("env://" if "RANK" in env and "WORLD_SIZE" in env
                       and "JAX_COORDINATOR_ADDRESS" not in env
                       else f"tcp://{addr}")
    dist.init_process_group(backend or default_backend(device),
                            init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return True


def is_main_process() -> bool:
    """Rank 0 of the group, or a process in none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def parse_mesh_shape(spec: str) -> int:
    """``--mesh_shape`` parser: "data:8" or "8" -> 8 ranks on the data
    axis; empty means no mesh (0)."""
    spec = (spec or "").strip()
    if not spec:
        return 0
    if ":" in spec:
        axis, _, n = spec.partition(":")
        if axis != DATA_AXIS:
            raise ValueError(f"unknown mesh axis {axis!r}; this workload "
                             f"shards over {DATA_AXIS!r} only")
        spec = n
    return int(spec)


def local_rank(rank: int) -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``, SLURM's ``SLURM_LOCALID``, else the rank)."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID"):
        if key in os.environ:
            return int(os.environ[key])
    return rank


@dataclass
class Mesh:
    """This process's place on the data axis: ``rank`` of ``world``, its
    ``device``, and whether its collectives go through host memory
    (``host``: gloo)."""
    rank: int
    world: int
    device: torch.device
    host: bool

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's share of ``n`` rows: ceil(n / world)
        rows a rank in order, the last shares short (the JAX package's
        padding, eval/sharded.py:64-72)."""
        per = -(-n // self.world)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)

    # -- collectives -------------------------------------------------------
    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.host else x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world * rows, ...) of every rank's ``x`` (same shape on every
        rank), in rank order, on ``x``'s device."""
        if not dist.is_initialized():
            return x
        wire = self._to_wire(x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        return torch.cat(parts).to(x.device)

    def all_reduce_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place."""
        if not dist.is_initialized():
            return x
        wire = self._to_wire(x)
        dist.all_reduce(wire)
        if wire is not x:
            x.copy_(wire)
        return x

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """The mean of each tensor over the ranks: one flat f32 bucket,
        one all-reduce."""
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        self.all_reduce_sum_(flat)
        flat = flat / self.world
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def gather_shards(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) whole of a tensor whose rows ``rows(n)`` this rank
        holds as ``x``: each share padded to ceil(n / world) rows, one
        all-gather, the padding (all at the end) dropped."""
        per = -(-n // self.world)
        pad = per - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return self.all_gather(x)[:n]

    def all_to_all(self, x: torch.Tensor, send: Sequence[int],
                   recv: Sequence[int]) -> torch.Tensor:
        """``x``'s rows exchanged: the next ``send[r]`` rows of ``x`` go to
        rank r, and the result holds ``recv[r]`` rows from each rank r, in
        rank order, on ``x``'s device."""
        wire = self._to_wire(x.contiguous())
        out = wire.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, wire, list(recv), list(send))
        return out.to(x.device)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()


@dataclass(frozen=True, eq=False)
class RowShard:
    """This rank's share of an entity-indexed feature table: rows
    ``[lo, hi)`` of the whole ``(n, ...)`` table as ``local``, on the
    rank's device.  The share is ``Mesh.rows(n)``, the split of every
    forward over all entities, so such a forward reads ``local`` alone.
    It is no tensor and cannot be indexed as if it were whole: rows of
    the whole come from ``take_rows`` (``take`` reads either kind)."""
    local: torch.Tensor
    lo: int
    hi: int
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole table's shape."""
        return (self.n,) + tuple(self.local.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device


Table = Union[torch.Tensor, RowShard]


def shard_table(mesh: Optional[Mesh], whole: torch.Tensor) -> Table:
    """What this rank keeps of a feature table: its ``RowShard`` under a
    mesh of N > 1 ranks (a copy, so that ``whole`` can be freed), else
    ``whole`` itself."""
    if mesh is None or mesh.world == 1:
        return whole
    if whole.requires_grad:
        raise ValueError("shard_table: feature tables take no gradient")
    lo, hi = mesh.rows(whole.shape[0])
    return RowShard(whole[lo:hi].clone(), lo, hi, whole.shape[0])


def take_rows(mesh: Mesh, shards: Sequence[RowShard],
              idxs: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Rows of the whole tables that ``shards`` are this rank's shares of
    (of one entity count): ``out[i][j]`` is rows ``idxs[i]`` (any shape,
    int32 or int64 ids) of table j, bit for bit ``whole[idxs[i]]``,
    contiguous, on the shards' device.  Every rank calls it together,
    each with its own ids (empty or not).  One plan serves every table
    and index set: the distinct ids, their owners, and one all-gather of
    the counts each rank asks of each other rank (which also carries a
    count of ids out of range, so that every rank raises).  A rank's own
    ids are read from its shares; only where some rank asks another for
    rows, one ``all_to_all_single`` of those ids and one of every table's
    rows together, as bytes.  Nothing falls back to a whole table."""
    first = shards[0]
    lo, hi, n = first.lo, first.hi, first.n
    if any((s.lo, s.hi, s.n) != (lo, hi, n) for s in shards):
        raise ValueError("take_rows: shares of tables of different spans")
    if any(s.local.requires_grad for s in shards):
        raise ValueError("take_rows: feature tables take no gradient")
    dev = first.device
    flat = [i.reshape(-1).to(dev, torch.int64) for i in idxs]
    ids, inverse = torch.unique(torch.cat(flat), sorted=True,
                                return_inverse=True)
    # the sorted ids of each owner, ids[bounds[r]:bounds[r + 1]]
    per = -(-n // mesh.world)
    bounds = torch.searchsorted(
        ids, torch.arange(mesh.world + 1, device=dev) * per)
    bad = ((ids < 0) | (ids >= n)).sum()
    head = torch.cat([bounds.diff(), bad[None]])
    counts = mesh.all_gather(head[None]).cpu()      # (world, world + 1)
    if counts[:, -1].any():
        raise IndexError(f"take_rows: ids outside [0, {n}) on ranks "
                         f"{counts[:, -1].nonzero().flatten().tolist()}")
    asks = counts[mesh.rank, :-1].tolist()          # ids to each owner
    gets = counts[:, mesh.rank].tolist()            # ids from each rank
    a = sum(asks[:mesh.rank])
    b = a + asks[mesh.rank]                         # this rank's own ids
    rows = [s.local[ids[a:b] - lo] for s in shards]
    asks[mesh.rank] = gets[mesh.rank] = 0
    pairs = counts[:, :-1]
    if pairs.sum() > pairs.diagonal().sum():        # a rank asks another
        wanted = mesh.all_to_all(torch.cat([ids[:a], ids[b:]]), asks,
                                 gets) - lo
        sent = [_bytes(s.local[wanted]) for s in shards]
        got = mesh.all_to_all(torch.cat(sent, dim=1), gets, asks)
        at = 0
        for j, t in enumerate(sent):
            part = got[:, at:at + t.shape[1]].clone(
                memory_format=torch.contiguous_format)
            part = part.view(rows[j].dtype).reshape(
                (got.shape[0],) + tuple(rows[j].shape[1:]))
            rows[j] = torch.cat([part[:a], rows[j], part[a:]])
            at += t.shape[1]
    result, at = [], 0
    for i, f in zip(idxs, flat):
        pick = inverse[at:at + f.shape[0]]
        result.append([r[pick].reshape(tuple(i.shape) + tuple(r.shape[1:]))
                       for r in rows])
        at += f.shape[0]
    return result


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s rows as (rows, bytes a row) of uint8."""
    return t.reshape(t.shape[0], math.prod(t.shape[1:])).view(torch.uint8)


def take_each(mesh: Optional[Mesh], tables: Sequence[Optional[Table]],
              idxs: Sequence) -> List[List[Optional[torch.Tensor]]]:
    """Rows of feature tables (None passes through) for each of
    ``idxs``: ``out[i][j]`` is ``tables[j][idxs[i]]`` of a whole table;
    of a ``RowShard``, its own rows for the index ``slice(lo, hi)`` of
    its share (no collective), else the rows that one ``take_rows`` of
    every shard and index set fetches."""
    shards = [t for t in tables if isinstance(t, RowShard)]
    ids = [i for i in idxs if not isinstance(i, slice)]
    fetched = iter(take_rows(mesh, shards, ids) if shards and ids else [])
    out = []
    for idx in idxs:
        got = (iter(next(fetched)) if shards and not isinstance(idx, slice)
               else None)
        row = []
        for t in tables:
            if t is None:
                row.append(None)
            elif not isinstance(t, RowShard):
                row.append(t[idx])
            elif got is not None:
                row.append(next(got))
            elif (idx.start, idx.stop) != (t.lo, t.hi):
                raise ValueError(f"rows {idx.start}:{idx.stop} of a shard "
                                 f"of rows {t.lo}:{t.hi}")
            else:
                row.append(t.local)
        out.append(row)
    return out


def take(mesh: Optional[Mesh], tables: Sequence[Optional[Table]], idx
         ) -> List[Optional[torch.Tensor]]:
    """``take_each`` of one index: rows ``idx`` of each table."""
    return take_each(mesh, tables, [idx])[0]


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank, in order.  Backward: this rank's
    rows of the gradient of the loss the ranks share.  Where the loss
    after the gather runs replicated (``replicated``), each rank's
    incoming gradient is that loss's, so its rows are taken times
    ``world``: each rank's gradient then holds the terms that come
    straight from the loss once and those through its own rows ``world``
    times, and the mean over the ranks (``all_reduce_mean``) holds each
    term once.  Where each rank's loss is over rows of its own, the
    incoming gradients are summed over the ranks first."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, n: int, replicated: bool):
        ctx.mesh, ctx.span, ctx.replicated = mesh, mesh.rows(n), replicated
        return mesh.gather_shards(x, n)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.span
        if ctx.replicated:
            return grad[lo:hi] * ctx.mesh.world, None, None, None
        return ctx.mesh.all_reduce_sum_(grad.clone())[lo:hi], None, None, None


def gather_rows(mesh: Mesh, tensors: Sequence[Optional[torch.Tensor]],
                n: int, replicated: bool = True
                ) -> List[Optional[torch.Tensor]]:
    """The (n, ...) wholes of per-row tensors whose rows ``mesh.rows(n)``
    this rank computed (None passes through): every field flattened into
    one f32 buffer (bf16 to f32 and back is exact), one differentiable
    gather (``_GatherRows``; ``replicated``: the loss after it is the
    same on every rank)."""
    present = [t for t in tensors if t is not None]
    flat = torch.cat([t.reshape(t.shape[0], -1).to(torch.float32)
                      for t in present], dim=1)
    whole = _GatherRows.apply(flat, mesh, n, replicated)
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        width = math.prod(t.shape[1:])
        out.append(whole[:, at:at + width].reshape(
            (n,) + tuple(t.shape[1:])).to(t.dtype))
        at += width
    return out


def attach(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Hand ``mesh`` to every submodule of ``model`` that splits its rows
    over one (those with a ``mesh`` attribute)."""
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh


def make_mesh(n: int, device: str, logger=None) -> Mesh:
    """The ``data:n`` mesh of this process.  A process in a group takes
    its rank there, and ``n`` must equal the group's size; a process in
    none is the one rank of ``data:1`` (its collectives are the
    identity), and ``n`` above 1 raises: launch N processes through the
    CLI, torchrun or SLURM.  A bare ``cuda`` device becomes the card of
    this rank's local index; NCCL with more ranks on a host than cards
    raises, as the JAX runner raises for more devices than it has."""
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"--mesh_shape data:{n} needs {n} processes in a group: "
                "start it through cli.train_mmea / cli.train_mkgc (which "
                "spawn them), torchrun or SLURM")
        rank, world, backend = 0, 1, None
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
        if n != world:
            raise ValueError(f"--mesh_shape data:{n} in a group of {world} "
                             f"processes: N must equal the group's size")
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank(rank))
        if backend == "nccl" and dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"--mesh_shape data:{n}: rank {rank} wants {dev}, have "
                f"{torch.cuda.device_count()} visible card(s); NCCL takes "
                "one rank per card")
        if backend == "nccl":
            torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError(f"--device {device}: NCCL needs a CUDA device")
    mesh = Mesh(rank=rank, world=world, device=dev, host=backend == "gloo")
    if logger is not None:
        logger.info(f"mesh: rank {rank} of {world} on {dev}, backend "
                    f"{backend or 'none (one rank)'}")
        if mesh.host and dev.type == "cuda":
            logger.info("mesh: gloo on CUDA tensors; every collective goes "
                        "through host memory")
    return mesh


def enter(n: int, device: str, entry, argv) -> Tuple[bool, bool]:
    """The CLIs' launch of ``--mesh_shape data:n``: (run here, own group).

    A process already in a group (torchrun, SLURM or ``JAX_*``
    variables, or a caller that made one) runs as its rank, and ``n``
    must equal the group's size.  Otherwise ``n`` above 1 spawns ``n``
    ranks that each call ``entry(argv)`` (NCCL on ``cuda``, one card a
    rank; gloo on the CPU) and this process runs nothing; ``n`` = 1 runs
    here in a group of one over the device's backend, which
    ``leave(True)`` ends."""
    if not n:
        return True, False
    if initialize_distributed(device=device):
        if dist.get_world_size() != n:
            raise ValueError(f"--mesh_shape data:{n} in a group of "
                             f"{dist.get_world_size()} processes "
                             "(WORLD_SIZE): N must equal it")
        return True, False
    if n > 1:
        spawn(n, entry, (argv,), device=device)
        return False, False
    dist.init_process_group(default_backend(device), store=dist.HashStore(),
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=TIMEOUT_S))
    return True, True


def leave(own_group: bool) -> None:
    if own_group and dist.is_initialized():
        dist.destroy_process_group()


def spawn(n: int, fn, args: tuple = (), backend: Optional[str] = None,
          device: str = "cuda") -> None:
    """Run ``fn(*args)`` in ``n`` new processes, each the rank of a group
    of ``n`` (rendezvous through a file in a fresh directory); a rank
    that raises makes this call raise.  ``backend`` defaults to NCCL for
    ``cuda`` and gloo for the CPU; NCCL wants ``n`` visible cards."""
    import torch.multiprocessing as mp
    backend = backend or default_backend(device)
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"--mesh_shape data:{n} over NCCL wants {n} cards, "
                         f"have {torch.cuda.device_count()} (NCCL refuses "
                         "two ranks on one card)")
    with tempfile.TemporaryDirectory(prefix="snag_mesh_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.spawn(_spawned, args=(n, init, backend, fn, args), nprocs=n,
                 join=True)


def _spawned(rank: int, n: int, init: str, backend: str, fn, args) -> None:
    initialize_distributed(backend, init_method=init, rank=rank,
                           world_size=n)
    fn(*args)
    # only on success: a rank that raises keeps its connections until its
    # process exits, after spawn has its error, so that the ranks waiting
    # in a collective for it, which fail when they close, are not reported
    # in its place
    dist.destroy_process_group()
