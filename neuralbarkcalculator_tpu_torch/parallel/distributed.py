"""The process group of a multi-process run and the collectives of the
data-parallel step (the port's counterpart of the JAX package's
parallel/mesh.py).

The JAX package shards a training batch over its mesh's ``data`` axis
with the parameters replicated, and GSPMD computes exactly the
single-device step on the global batch. The port runs one process per
card (``torchrun --nproc_per_node N``, or N shells), each holding every
parameter and 1/N of the global batch's rows, and makes that step
explicit through a ``World``:

- ``rank_slice``: the rank's contiguous rows of a global batch; a batch
  that does not divide raises ``ValueError``, as a jitted step with a
  data-sharded input does;
- ``gather_rows``: every rank's rows, concatenated into the global batch.
  It is differentiable, and its backward hands each rank the gradient of
  its own rows, so every rank computes the same global loss and metrics;
- ``all_reduce_sum``: a differentiable sum across ranks (the cross-rank
  BatchNorm's per-channel sums, parallel/sync_bn.py), forward and backward
  inside the program span ``train/collective/bn``;
- ``all_reduce_grads``: after ``backward()`` each rank's parameter
  gradients hold only its own rows' share of the global loss's gradient;
  their sum (GSPMD's psum) is the single-process gradient, the same on
  every rank, so the ranks' optimizer steps stay equal.

A world without a process group (``single_process``) is one rank and
issues no collective. Every single-process caller gets one and runs the
same code path, as the JAX package's 1x1 mesh does. With a group, even
of size 1, every collective goes to torch.distributed: NCCL on a card,
gloo on the CPU.

Folder prediction runs on a ``Mesh`` (``make_mesh``), the JAX mesh's
``(data, model)`` grid of processes: the launch batch's rows split over
``data`` and the image width over ``model`` (parallel/spatial.py,
pipeline/predict.py). Streaming prediction and the server read their
images on grid rank 0 alone, which hands every rank each chunk's plan
and pixels (``World.broadcast_ints``, ``World.broadcast_u8``). Its
``--shard K/N`` processes are another thing: independent, they meet
only on the filesystem (pipeline/multihost.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.profiling import stage_timer


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (and >= m)."""
    return max(m, ((n + m - 1) // m) * m)


# the program span of ``all_reduce_sum``'s all-reduces, forward and
# backward: its one use is the cross-rank BatchNorm's
SUM_SPAN = "train/collective/bn"


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` across ranks; its gradient is the sum of the
    ranks' gradients of the result, which each rank holds a share of.
    Both all-reduces run inside the program span ``SUM_SPAN``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        with stage_timer(SUM_SPAN):
            y = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        with stage_timer(SUM_SPAN):
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows in rank order; the backward keeps the rank's own
    rows of the gradient. Every rank computes the same function of the
    gathered batch, so the gradient it holds for its rows is already the
    whole gradient there: summing across ranks here would count it once a
    rank."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.rows = world.rank_slice(x.shape[0] * world.size)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world.size)]
        dist.all_gather(parts, x, group=world.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


@dataclasses.dataclass(frozen=True)
class World:
    """One rank of a data-parallel run: its rank, the number of ranks, its
    device and the process group (None for a single process)."""

    rank: int
    size: int
    device: torch.device
    group: object | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the run's files."""
        return self.rank == 0

    def rank_slice(self, n_global: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n_global``."""
        if n_global % self.size:
            raise ValueError(f"a global batch of {n_global} does not divide "
                             f"across {self.size} ranks")
        b = n_global // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def pad_rows(self, rows: np.ndarray) -> np.ndarray:
        """``rows`` padded to a multiple of the world size with repeats of
        its last entry (JAX train/loop.py:316-340); the caller weights the
        padding 0."""
        pad = pad_to_multiple(len(rows), self.size) - len(rows)
        return np.concatenate([rows, np.repeat(rows[-1:], pad)])

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable."""
        if self.group is None:
            return x
        return _AllReduceSum.apply(x, self.group)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from each rank's rows of ``x`` (equal shapes on
        every rank), differentiable."""
        if self.group is None:
            return x
        return _GatherRows.apply(x, self)

    def all_reduce_grads(self, params) -> None:
        """Sum each parameter's gradient over the ranks, in place, with one
        collective over the flattened gradients."""
        if self.group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()

    def broadcast_ints(self, values: Sequence[int] | None) -> list[int]:
        """Rank 0's ``values`` (a short header of int64s; None on the other
        ranks) on every rank: its length, then the values, each one
        broadcast."""
        if self.group is None:
            return list(values)
        src = dist.get_global_rank(self.group, 0)
        n = torch.tensor([len(values) if self.rank == 0 else 0],
                         dtype=torch.int64, device=self.device)
        dist.broadcast(n, src, group=self.group)
        buf = (torch.tensor(list(values), dtype=torch.int64,
                            device=self.device) if self.rank == 0
               else torch.empty(int(n.item()), dtype=torch.int64,
                                device=self.device))
        dist.broadcast(buf, src, group=self.group)
        return buf.tolist()

    def broadcast_u8(self, data: np.ndarray | None, nbytes: int
                     ) -> np.ndarray:
        """Rank 0's ``nbytes`` bytes (``data``, any uint8 array; None on
        the other ranks) on every rank, as a flat uint8 array on the
        host."""
        if self.group is None:
            return np.ascontiguousarray(data).reshape(-1)
        buf = (torch.from_numpy(np.ascontiguousarray(data).reshape(-1))
               .to(self.device) if self.rank == 0
               else torch.empty(nbytes, dtype=torch.uint8,
                                device=self.device))
        if buf.numel() != nbytes:
            raise ValueError(f"broadcast_u8: {buf.numel()} bytes, the "
                             f"header says {nbytes}")
        dist.broadcast(buf, dist.get_global_rank(self.group, 0),
                       group=self.group)
        return buf.cpu().numpy()

    def barrier(self) -> None:
        """Return once every rank has reached this point: a one-element
        all-reduce, read back so the host waits for it on NCCL too."""
        if self.group is None:
            return
        token = torch.zeros(1, device=self.device)
        dist.all_reduce(token, group=self.group)
        token.item()


def single_process(device: str | torch.device = "cpu") -> World:
    """The world of a single process: rank 0 of 1, no collectives."""
    return World(0, 1, torch.device(device))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` grid of processes (JAX
    parallel/mesh.py's ``make_mesh`` and ``ShardingRules``): the whole
    ``world``, the ``data`` group (the ranks that hold the same columns of
    other rows of a launch batch) and the ``model`` group (the ranks that
    split the same rows' width). An axis of size 1 is a ``World`` without
    a group, so it issues no collective."""

    world: World
    data: World
    model: World

    @property
    def data_size(self) -> int:
        return self.data.size

    @property
    def model_size(self) -> int:
        return self.model.size

    @property
    def n_devices(self) -> int:
        return self.world.size

    @property
    def data_rank(self) -> int:
        return self.data.rank

    @property
    def model_rank(self) -> int:
        return self.model.rank

    @property
    def is_main(self) -> bool:
        """Grid rank 0 writes the run's files."""
        return self.world.is_main


def _axis(world: World, groups: list[list[int]]) -> World:
    """This rank's group among ``groups`` (every rank builds every group,
    in the same order, as ``dist.new_group`` requires)."""
    if len(groups[0]) == 1:
        return World(0, 1, world.device)
    for ranks in groups:
        group = dist.new_group(ranks)
        if world.rank in ranks:
            mine = World(ranks.index(world.rank), len(ranks), world.device,
                         group)
    return mine


def make_mesh(n_data: int | None = None, n_model: int = 1,
              world: World | None = None) -> Mesh:
    """A ``(data, model)`` grid over ``world``'s ranks (a single process
    when None), numbered row-major as JAX's ``np.reshape(n_data,
    n_model)``: rank = d x n_model + m. ``n_data`` defaults to
    ``world.size // n_model``. Every rank of the grid works: raises
    ``ValueError`` unless n_data x n_model == world.size (JAX leaves
    spare devices idle; here each rank is a process that must take part
    in every collective)."""
    world = world if world is not None else single_process()
    if n_data is None:
        n_data = max(1, world.size // n_model)
    if n_data < 1 or n_model < 1 or n_data * n_model != world.size:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} ranks; the world has "
                         f"{world.size}")
    rows = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    columns = [[d * n_model + m for d in range(n_data)]
               for m in range(n_model)]
    return Mesh(world, data=_axis(world, columns), model=_axis(world, rows))


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """``cuda`` names this process's card, ``cuda:LOCAL_RANK`` (torchrun's
    variable; 0 when unset); ``cpu`` and an indexed card stay as they
    are. Raises, as every entry point does, when a card is asked for and
    there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize_distributed(backend: str | None = None,
                           init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None,
                           device: str | torch.device = "cuda") -> World:
    """Join the process group and return this process's ``World``.

    The identity comes from the arguments, else from torchrun's
    environment (``RANK``, ``WORLD_SIZE``; ``MASTER_ADDR`` and
    ``MASTER_PORT`` through the default ``env://`` rendezvous). The device
    is ``cuda:LOCAL_RANK`` unless the caller asks for the CPU; the backend
    is NCCL on a card and gloo on the CPU unless named. A process that has
    already joined gets its world back."""
    dev = local_device(device)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank,
            world_size=world_size)
    return World(dist.get_rank(), dist.get_world_size(), dev,
                 dist.group.WORLD)


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
