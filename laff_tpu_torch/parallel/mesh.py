"""Process groups, batch sharding and the launcher (``laff_tpu.parallel.mesh``).

``laff_tpu`` scales as one SPMD program over a 'dp' device mesh: batches
sharded along 'dp', parameters replicated, and the collectives (the
gradient psum, global BatchNorm statistics, the all-gather of embeddings
for hardest-negative mining) inserted by XLA. The port runs the same
program as one process per card over ``torch.distributed``: NCCL between
cards, gloo on the CPU. Every rank runs the same loop on identically
seeded feeds and keeps its rows of each global batch
(``shard_batch(..., from_global=True)``); parameters are replicated
(``replicate`` broadcasts rank 0's); ``laff_tpu``'s ``psum`` is
``all_reduce(SUM)`` and its ``all_gather`` is ``all_gather``; only rank 0
touches the filesystem.

* ``Mesh``: this rank's place in a process group (``rank`` and ``size``
  within ``group``, the default group when None), this rank's device and
  the axis name 'dp'; every collective of the port runs through it, over
  its group.
* ``seed_data_mesh(n_seed, n_dp)``: the seed x dp layout of a sweep over
  a mesh. The world's ranks form ``n_seed`` rows of ``n_dp``; a rank's
  'dp' mesh is its row (a group of its own), and nothing crosses rows.
* ``launch(n, target, *args)``: ``n`` ranks of a module-level ``target``
  (called as ``target(mesh, *args)``), each on its card
  (``torch.cuda.set_device`` before anything allocates), joined through a
  ``FileStore`` in a temporary directory; rank 0's result is returned, and
  a rank that fails stops the others and raises here. The CUDA kernels and
  the native featurizer are built in the caller before any rank starts.
* ``gather_rows`` and ``all_reduce_sum``: the two collectives of a
  data-parallel train step, as autograd functions. Every rank computes the
  same loss from the gathered rows, so the gradient that reaches the
  gather is whole on each rank, and its backward keeps this rank's rows
  (no sum: a sum would count the world's copies of one loss). A sum
  over the group (BatchNorm's statistics) passes each rank's share of the
  gradient back, so its backward sums the gradients over the group. The
  parameters' gradients are then each rank's share and are summed once,
  over the flat gradient buffer (``engine.optim.OptaxChain``).
* ``ShardedGenerator``: the epoch generator of a data-parallel step. A
  random draw over batch rows (dropout masks, the zero-feature noise) is
  drawn for the global batch's shape and sliced to this rank's rows, so an
  N-card run draws what a one-card run draws; BatchNorm and the
  zero-feature test read the mesh from it to reduce over the group.

A subgroup's collectives name their source and destination by global
rank (``dist.get_global_rank``), and its NCCL communicator exists only
after its first eager collective: a CUDA graph that captures one must come
after it (``trainer.TrainRun`` replicates the model first).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist


# the one-tensor all-gather: all_gather_single in newer torch, which deprecates
# all_gather_into_tensor (the same call)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass
class Mesh:
    """A process group as a data-parallel mesh: ``size`` ranks along
    ``axis``, this process being ``rank`` of them, its tensors on
    ``device``; ``group`` is the process group (None: the default one)."""

    rank: int
    size: int
    device: torch.device
    axis: str = "dp"
    group: Optional[Any] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def global_rank(self, rank: int) -> int:
        """The world rank of this group's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the group."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0, in
        rank order."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _all_gather_single(out, t, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, self.global_rank(src), group=self.group)
        return t

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, self.global_rank(src), group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def gather_object(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's picklable ``obj`` in rank order on rank 0, None on
        the others."""
        out = [None] * self.size if self.is_main else None
        dist.gather_object(obj, out, dst=self.global_rank(0), group=self.group)
        return out

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


@dataclasses.dataclass
class SeedDataMesh:
    """The ('seed', 'dp') layout of ``seed_data_mesh``: ``row`` is this
    rank's 'dp' mesh (its row's group), ``world`` the mesh of every rank."""

    n_seed: int
    n_dp: int
    row: Mesh
    world: Mesh

    @property
    def shape(self) -> Dict[str, int]:
        return {"seed": self.n_seed, "dp": self.n_dp}

    @property
    def seed_index(self) -> int:
        """This rank's row."""
        return self.world.rank // self.n_dp


def _device_for_backend() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_parallel_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """The mesh over the initialized default process group (every rank of
    the run); ``n_devices``, when given, must be its size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with launch() or torchrun "
                           "(initialize_multihost)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices over a group of {size} ranks")
    return Mesh(rank=dist.get_rank(), size=size, device=_device_for_backend(), axis=axis)


def seed_data_mesh(n_seed: int, n_dp: int) -> SeedDataMesh:
    """The seed x dp layout over the world's ``n_seed * n_dp`` ranks: row
    ``i`` is ranks ``i * n_dp .. (i + 1) * n_dp - 1``, each row a process
    group of its own (every rank creates every row's group, in order)."""
    world = data_parallel_mesh()
    n = n_seed * n_dp
    if world.size != n:
        raise ValueError(f"need {n} devices, have {world.size}")
    groups = [dist.new_group(list(range(i * n_dp, (i + 1) * n_dp))) for i in range(n_seed)]
    i = world.rank // n_dp
    row = Mesh(rank=world.rank - i * n_dp, size=n_dp, device=world.device, group=groups[i])
    return SeedDataMesh(n_seed=n_seed, n_dp=n_dp, row=row, world=world)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join a multi-process run: from the arguments, or from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``). NCCL with a card (this rank's card is
    ``LOCAL_RANK``), gloo without. A no-op in a single process and when the
    group exists. Returns the number of processes."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "WORLD_SIZE" not in env:
        return 1
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    init = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, world_size=world,
                            rank=rank)
    return world


def _rows(x, mesh: Mesh, axis_index: int):
    b = x.shape[axis_index]
    if b % mesh.size:
        raise ValueError(f"global batch axis {b} must divide by {mesh.size} ranks")
    per = b // mesh.size
    idx = [slice(None)] * x.ndim
    idx[axis_index] = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return x[tuple(idx)]


def shard_batch(batch, mesh: Mesh, axis: str = "dp", axis_index: int = 0,
                from_global: bool = False):
    """This rank's rows of a batch (a tensor, an array, or a dict of them)
    along ``axis_index``. ``from_global=True``: the arrays are the global
    batch, identical on every rank (the feeds are seeded alike), and this
    rank keeps its contiguous slice (rank order); raises when the axis does
    not divide by the world. ``from_global=False``: each process already
    fed its own rows, which are returned as they are."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    if not from_global:
        return batch
    if isinstance(batch, dict):
        return {k: _rows(v, mesh, axis_index) for k, v in batch.items()}
    return _rows(batch, mesh, axis_index)


def replicate(module_or_tensors, mesh: Mesh):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, a tensor, or a dict or list of tensors. Returns its input."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [*module_or_tensors.parameters(), *module_or_tensors.buffers()]
    elif isinstance(module_or_tensors, torch.Tensor):
        tensors = [module_or_tensors]
    elif isinstance(module_or_tensors, dict):
        tensors = list(module_or_tensors.values())
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast(t.data)
    return module_or_tensors


# ---------------------------------------------------------------------------
# the collectives of a data-parallel step
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return mesh.all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.rank * ctx.rows
        return grad[start:start + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone()), None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order (the global batch), with
    this rank's rows' gradient passed back (see the module docstring)."""
    if mesh is None or mesh.size == 1:
        return x
    return _GatherRows.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the group, the gradient summed back."""
    if mesh is None or mesh.size == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


class ShardedGenerator:
    """A data-parallel step's generator and mesh (see the module docstring).
    The forwards take it where they take a ``torch.Generator``."""

    def __init__(self, generator: Optional[torch.Generator], mesh: Mesh) -> None:
        self.generator = generator
        self.mesh = mesh


def step_mesh(generator) -> Optional[Mesh]:
    """The mesh of a data-parallel step's generator, else None."""
    if isinstance(generator, ShardedGenerator) and generator.mesh.size > 1:
        return generator.mesh
    return None


def torch_generator(generator) -> Optional[torch.Generator]:
    """The ``torch.Generator`` for draws that are not over batch rows."""
    return generator.generator if isinstance(generator, ShardedGenerator) else generator


def _row_draw(fn, shape, generator, device) -> torch.Tensor:
    mesh = step_mesh(generator)
    if mesh is None:
        return fn(shape, generator=torch_generator(generator), device=device)
    n = shape[0]
    out = fn((n * mesh.size, *shape[1:]), generator=generator.generator, device=device)
    return out[mesh.rank * n:(mesh.rank + 1) * n]


def rand_rows(shape, generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` over batch rows (dim 0): under a data-parallel
    step the global batch's draw, this rank's rows."""
    return _row_draw(torch.rand, shape, generator, device)


def randn_rows(shape, generator, device) -> torch.Tensor:
    """``torch.randn`` as ``rand_rows`` draws."""
    return _row_draw(torch.randn, shape, generator, device)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_RESULT = "result.pkl"


def _rank_entry(rank: int, n: int, tmp: str, device_type: str,
                target: Callable, args: tuple) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)  # before anything allocates on a card
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=n)
    mesh = data_parallel_mesh()
    try:
        result = target(mesh, *args)
    except BaseException:
        # a failed rank leaves at once: the others may wait in a collective it
        # never joins, and tearing the group down would wait on them; the
        # launcher sees the exit code and terminates them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if rank == 0:
        with open(os.path.join(tmp, _RESULT), "wb") as fh:
            pickle.dump(result, fh)
    mesh.barrier()
    dist.destroy_process_group()


def launch(n: int, target: Callable, *args, device: str = "cuda",
           workdir: Optional[str] = None):
    """Run ``target(mesh, *args)`` on ``n`` ranks, one process each (spawned),
    rank r on card r for a CUDA ``device`` (gloo ranks on the CPU), and
    return rank 0's result. The kernels and the native featurizer are built
    here first, so no two ranks compile into the build directory at once. A
    rank that fails terminates the others and raises here. The group's
    ``FileStore`` lives in a temporary directory (under ``workdir`` when
    given), removed at the end."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    from .. import native
    from ..ops import kernels

    if dev.type == "cuda":
        if n > torch.cuda.device_count():
            raise RuntimeError(f"{n} ranks over {torch.cuda.device_count()} visible cards")
        kernels.build_kernels()
    native.get_fastfeat()
    with tempfile.TemporaryDirectory(prefix="laff_dp_", dir=workdir) as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(n, tmp, dev.type, target, args), nprocs=n, join=False,
            start_method="spawn")
        while not ctx.join():
            pass
        with open(os.path.join(tmp, _RESULT), "rb") as fh:
            return pickle.load(fh)
