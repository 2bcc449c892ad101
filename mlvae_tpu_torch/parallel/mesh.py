"""Process groups, the rank layout and the collectives of data and tensor
parallelism (counterpart of ``mlvae_tpu/parallel/mesh.py`` and
``mlvae_tpu/parallel/tp.py`` ``make_mesh_2d``).

The JAX package puts one ``Mesh`` over its devices and lets GSPMD insert
the collectives. Here every device is a process (a rank) and the
collectives are explicit. ``launch`` starts the ranks with
``torch.multiprocessing`` and ``init_mesh`` joins one to the others.

Rank layout, as ``make_mesh_2d`` lays the devices out: rank ``d *
n_model + m`` sits at data index d and model index m, so that the
neighbours on the model axis are adjacent. A rank belongs to one data
group (the ranks of its model index, which hold different rows of the
batch) and one model group (the ranks of its data index, which hold the
same rows and different shards of a tensor-split module).

Backend rule (``choose_backend``, logged by ``init_mesh``): NCCL where
every rank has a card of its own; gloo on the CPU and where ranks share a
card, since NCCL refuses two ranks on one device. Gloo takes CUDA tensors
in the four collectives below (all-reduce, all-gather, reduce-scatter,
broadcast; held on the H100 by ``chip_smoke.py``'s probe), copying
through host memory itself. An init failure raises; nothing falls back
to one process or to the CPU.

``shard_rows`` / ``shard_batch`` give this rank's rows of the global
batch, which ``pad_rows`` first pads to a multiple of the data axis by
repeating its last row (the JAX Brain's ``to_device_batch``);
``replicate`` broadcasts tensors from rank 0; ``gather_rows`` is the
all-gather of a batch-major tensor over the data group, differentiable:
its backward hands each rank the gradient of its own rows.
"""
from __future__ import annotations

import datetime
import inspect
import logging
import socket
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# how long a rank waits for the others in a collective or at init
TIMEOUT_S = 600


@dataclass
class Mesh:
    world: int
    rank: int
    n_data: int
    n_model: int
    backend: str
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone logs, writes checkpoints and writes outputs."""
        return self.rank == 0


_MESH: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """The mesh this process belongs to, or None outside ``launch``."""
    return _MESH


def solo() -> Mesh:
    """The mesh of one process outside ``launch``: one rank, no process
    group, so that every collective returns its input."""
    return Mesh(1, 0, 1, 1, "none", None)


def data_size() -> int:
    """The data axis of the current mesh (1 outside one)."""
    return _MESH.n_data if _MESH is not None else 1


def rank_grid(n_data: int, n_model: int) -> np.ndarray:
    """(n_data, n_model) global ranks: model-axis neighbours adjacent."""
    return np.arange(n_data * n_model).reshape(n_data, n_model)


def check_split(n_devices: int, n_model: int) -> None:
    if n_model < 1 or n_devices % n_model:
        raise ValueError(f"num_devices={n_devices} not divisible by "
                         f"tensor_parallel={n_model}")


def choose_backend(device_type: str, world: int, n_cards: int) -> str:
    """NCCL when each rank has a card of its own, gloo otherwise."""
    return "nccl" if device_type == "cuda" and n_cards >= world else "gloo"


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_mesh(rank: int, world: int, n_model: int, port: int,
              device_type: str = "cuda") -> Mesh:
    """Join the process group at ``tcp://127.0.0.1:port`` as ``rank`` of
    ``world`` and build the data and model groups."""
    global _MESH
    check_split(world, n_model)
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        if n_cards == 0:
            raise RuntimeError("CUDA is not available; pass --device cpu to "
                               "run the ranks on the CPU")
        device = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = choose_backend(device_type, world, n_cards)
    kwargs = dict(init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                  world_size=world,
                  timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        kwargs["device_id"] = device    # binds the communicator at once
    dist.init_process_group(backend, **kwargs)
    _MESH = Mesh(world, rank, world, 1, backend, device)
    mesh = set_layout(n_model)
    if rank == 0:
        logger.info("mesh: data=%d x model=%d over %s (%s: %s)",
                    mesh.n_data, n_model, device_type, backend,
                    "a card a rank" if backend == "nccl" else
                    "ranks share a card" if device_type == "cuda"
                    else "CPU ranks")
    return mesh


def set_layout(n_model: int) -> Mesh:
    """Lay the current mesh's ranks out anew as data = world / n_model x
    model = ``n_model``, with groups of their own; every rank calls it."""
    global _MESH
    world, rank = _MESH.world, _MESH.rank
    check_split(world, n_model)
    n_data = world // n_model
    grid = rank_grid(n_data, n_model)
    mesh = Mesh(world, rank, n_data, n_model, _MESH.backend, _MESH.device)
    # every rank creates every group, in the same order
    for m in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if m == mesh.model_rank:
            mesh.data_group = g
    for d in range(n_data):
        g = dist.new_group([int(r) for r in grid[d, :]])
        if d == mesh.data_rank:
            mesh.model_group = g
    _MESH = mesh
    return mesh


def destroy_mesh() -> None:
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def _rank_main(rank: int, world: int, n_model: int, port: int,
               device_type: str, fn: Callable, args: tuple) -> None:
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(levelname)s:%(name)s:%(message)s")
    init_mesh(rank, world, n_model, port, device_type)
    try:
        fn(*args)
        barrier()
    finally:
        destroy_mesh()


def launch(fn: Callable, args: tuple, world: int, n_model: int = 1,
           device_type: str = "cuda") -> None:
    """Run ``fn(*args)`` in ``world`` new processes, each joined to the
    mesh (data = world / n_model, model = n_model). Raises if a rank
    fails; the others are then stopped."""
    import torch.multiprocessing as mp
    check_split(world, n_model)
    port = free_port()
    mp.start_processes(_rank_main, args=(world, n_model, port, device_type,
                                         fn, args),
                       nprocs=world, join=True, start_method="spawn")


# -- collectives ---------------------------------------------------------------
def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The reduction of ``t`` over ``group``: a new tensor, or ``t``
    itself (detached) in a group of one."""
    if _size(group) == 1:
        return t.detach()
    buf = t.detach().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0
                   ) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order; every
    rank's tensor must have the same shape (``t`` itself, detached, in a
    group of one)."""
    n = _size(group)
    src = t.detach().contiguous()
    if n == 1:
        return src
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(bufs, src, group=group)
    return torch.cat(bufs, dim=dim)


def reduce_scatter_flat(flat: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` of the 1-D ``flat`` (its length a multiple
    of the group's size), split in contiguous pieces: this rank's piece
    (``flat`` itself, detached, in a group of one)."""
    n = _size(group)
    if n == 1:
        return flat.detach()
    chunks = [c.contiguous() for c in flat.detach().chunk(n)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> None:
    """Overwrite ``t`` with global rank ``src``'s ``t``, in place."""
    if _size(group) > 1:
        dist.broadcast(t.data, src, group=group)


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        # gloo's barrier is an all-reduce on the CPU: no card is touched
        dist.all_reduce(torch.zeros(1), group=_cpu_group())


_CPU_GROUP = None


def _cpu_group():
    """A gloo group over the world, for host-only agreement (barriers)."""
    global _CPU_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _CPU_GROUP is None:
        _CPU_GROUP = dist.new_group(backend="gloo")
    return _CPU_GROUP


def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Broadcast every tensor from rank 0 (the JAX ``replicate``)."""
    for t in tensors:
        broadcast_(t, 0)


# -- batch rows ------------------------------------------------------------------
def padded_rows(n: int, multiple: int) -> int:
    return n + (-n) % multiple


def pad_rows(x, multiple: int):
    """``x`` (array or tensor) with its last row repeated until its leading
    dim is a multiple of ``multiple``."""
    extra = (-x.shape[0]) % multiple
    if not extra:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(extra, *x.shape[1:])])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], extra, axis=0)])


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of ``n_rows`` (a multiple of the data
    axis): contiguous, in data-rank order."""
    if n_rows % mesh.n_data:
        raise ValueError(f"a batch of {n_rows} rows does not split over "
                         f"{mesh.n_data} data ranks; pad it first")
    per = n_rows // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(dev_batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of every (array, relative lengths) entry of a
    padded device batch (and of its ids)."""
    out = {}
    for key, value in dev_batch.items():
        if key == "id":
            n = len(value)
            out[key] = list(value)[shard_rows(n, mesh)]
            continue
        arr, lens = value
        rows = shard_rows(arr.shape[0], mesh)
        out[key] = (arr[rows], lens[rows])
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rows):
        ctx.rows = rows
        return all_gather_cat(x, group, 0)

    @staticmethod
    def backward(ctx, grad):
        # every rank holds the same loss of the gathered tensor: its
        # gradient is this rank's rows, summed over ranks by the step
        return grad[ctx.rows], None, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather a batch-major tensor over the data group, in data-rank
    order; differentiable."""
    n = x.shape[0]
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    if x.requires_grad:
        return _GatherRows.apply(x, mesh.data_group, rows)
    return all_gather_cat(x, mesh.data_group, 0)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` in the forward; in the backward too, since each
    rank holds only its own rows' share of the gradient of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def data_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group of the current mesh (``t`` itself
    outside one), differentiable: the global-batch reductions of the
    forward (the normalizer's statistics, the wav2vec2 whole-tensor
    norms)."""
    if data_size() == 1:
        return t
    if t.requires_grad:
        return _AllReduceSum.apply(t, _MESH.data_group)
    return all_reduce(t, _MESH.data_group)
