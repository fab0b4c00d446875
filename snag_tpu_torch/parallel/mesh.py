"""Multi-GPU runtime: ``--mesh_shape data:N`` over ``torch.distributed``.

Port of ``snag_tpu/parallel/mesh.py``: one process per GPU (a rank), NCCL
between cards and gloo on the CPU.  Every rank loads the same KG from the
same seed and holds it whole; what the ranks split is the per-entity work
(``Mesh.rows`` / ``gather_rows``, used by the MMEA encoders), the
evaluation's query rows (``eval/sharded.py``), the IL mining's left
candidates (``train/il.py``) and MKGC's batch rows and evaluation chunks.
Parameters are replicated and ``all_reduce_mean`` averages their gradients
before each optimizer update, as XLA's psum sums them under the JAX mesh.
The JAX package's entity-sharded placement of the feature tables
(``shard_kg_arrays``) is not ported: it saves memory and changes no
result.

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
from typing import List, Optional, Sequence, Tuple

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

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank, in order.  Backward: this rank's
    rows of the incoming gradient times ``world``.  The loss after the
    gather runs replicated, so each rank's gradient holds the terms that
    come straight from the loss once and those through its own rows
    ``world`` times; the mean over the ranks (``all_reduce_mean``) then
    holds each term once."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, n: int):
        ctx.mesh, ctx.span = mesh, mesh.rows(n)
        return mesh.gather_shards(x, n)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.span
        return grad[lo:hi] * ctx.mesh.world, None, None


def gather_rows(mesh: Mesh, tensors: Sequence[Optional[torch.Tensor]],
                n: int) -> List[Optional[torch.Tensor]]:
    """The (n, ...) wholes of per-row tensors whose rows ``mesh.rows(n)``
    this rank computed (None passes through): every field flattened into
    one f32 buffer (bf16 to f32 and back is exact), one differentiable
    gather."""
    present = [t for t in tensors if t is not None]
    flat = torch.cat([t.reshape(t.shape[0], -1).to(torch.float32)
                      for t in present], dim=1)
    whole = _GatherRows.apply(flat, mesh, n)
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
