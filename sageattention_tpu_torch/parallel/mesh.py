"""Process groups and the ("data", "seq", "heads") device mesh.

The counterpart of the JAX package's ``parallel/mesh.py``.  Where JAX names
the axes of a ``jax.sharding.Mesh`` over its devices and ``shard_map`` runs
one program over all of them, the port names the dims of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group, one process a rank: a card each over NCCL (``device_type="cuda"``,
the default), or CPU processes over gloo (``device_type="cpu"``, the
tests).  ``data`` carries data parallelism and the classifier-free-guidance
pair, ``seq`` the KV ring (context parallelism), ``heads`` Ulysses.

    initialize_multihost()                 # under torchrun: env://
    mesh = make_mesh(data=1, seq=2, heads=2)

Nothing here falls back: a mesh asked for on ``cuda`` without a GPU, or
without a process group, raises.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "seq", "heads")


def _require_cuda(device_type: str) -> None:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' to run the "
            "parallel entry points over gloo on the CPU"
        )


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, *, device_type: str = "cuda",
                         store=None, timeout_s: float = 600.0) -> None:
    """Join the process group: NCCL for ``cuda``, gloo for ``cpu``.

    With no arguments the rendezvous is torchrun's (``env://``: the
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` it exports); or
    pass ``init_method`` (``tcp://host:port``, ``file://path``) or a
    ``store`` with ``world_size`` and ``rank``.  On ``cuda`` each process
    takes the card ``LOCAL_RANK`` names (0 without torchrun)."""
    _require_cuda(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kw = {} if world_size is None else {"world_size": world_size, "rank": rank}
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_mesh(data: int = 1, seq: int = 1, heads: int = 1, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "seq", "heads") mesh over the ranks of the process group,
    rank-major in that order (``heads`` varies fastest).  The degrees must
    multiply to the world size."""
    _require_cuda(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialized: call initialize_multihost() (or "
            "torch.distributed.init_process_group) first"
        )
    n = data * seq * heads
    if n != dist.get_world_size():
        raise ValueError(f"data*seq*heads = {n} must equal the world size "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (data, seq, heads), mesh_dim_names=AXES)


def make_multihost_mesh(data: int = 1, seq: int = 1, heads: int = 1, *,
                        device_type: str = "cuda") -> DeviceMesh:
    """:func:`make_mesh` over the torchrun world, joining it first if this
    process has not (torchrun places a host's ranks on consecutive ids, so
    the fastest axes stay inside a host)."""
    if not dist.is_initialized():
        initialize_multihost(device_type=device_type)
    return make_mesh(data, seq, heads, device_type=device_type)


def axis_info(mesh: DeviceMesh, name: str | None):
    """(group, size, this rank's coordinate) of a mesh dim; an axis that is
    None, or that the mesh lacks, composes away as (None, 1, 0)."""
    if name is None or name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    i = mesh.mesh_dim_names.index(name)
    return mesh.get_group(i), mesh.shape[i], mesh.get_local_rank(i)


def require_axis(mesh: DeviceMesh, name: str) -> None:
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {name!r} (axes: {mesh.mesh_dim_names})")


def take_shard(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` equal blocks of ``x`` along ``dim``."""
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split {n} ways")
    s = x.shape[dim] // n
    return x.narrow(dim, i * s, s)


def global_view(mesh, data_axis: str | None, seq_axes):
    """shard_map's global view over ``mesh``: ``(take, give)``.  ``take(x)``
    cuts this rank's block of a global [b, h, S, ...] tensor: the batch by
    its ``data_axis`` coordinate, the sequence by its coordinates on
    ``seq_axes``, the first the slowest (JAX's ``P(data, None, seq_axes)``);
    ``give(x)`` all-gathers every rank's blocks back into the global
    tensor.

    Both are differentiable and each is the other's transpose.  Every rank
    holds the same replicated global tensors, so ``give``'s cotangent is
    the same on every rank and goes back as this rank's own block of it,
    with no sum; ``take``'s goes back as the all-gather of every rank's
    block.  Each rank's gradient of a global input is then the whole
    global gradient, what ``jax.grad`` of the shard_mapped function gives,
    and not n times it (``torch.distributed.nn``'s all-gather transposes
    to a reduce-scatter sum, which would)."""
    dgroup, dn, di = axis_info(mesh, data_axis)
    seq = [axis_info(mesh, a) for a in seq_axes]
    n, i = 1, 0
    for _, an, ai in seq:
        n, i = n * an, i * an + ai

    def cut(x):
        return take_shard(take_shard(x, 0, dn, di), 2, n, i).contiguous()

    def gather(x):
        for group, an, _ in reversed(seq):  # the fastest axis first
            x = gather_shards(x, 2, group, an)
        return gather_shards(x, 0, dgroup, dn)

    return (lambda x: with_transpose(x, cut, gather),
            lambda x: with_transpose(x, gather, cut))


def with_transpose(x: torch.Tensor, fn, transpose) -> torch.Tensor:
    """``fn(x)``, differentiable with ``transpose(g)`` as its backward: a
    collective whose transpose is another one."""
    return _Transposed.apply(x, fn, transpose)


class _Transposed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn, transpose):
        ctx.transpose = transpose
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transpose(g), None, None


def gather_shards(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of every rank of ``group`` concatenated along ``dim`` in
    rank order (the inverse of :func:`take_shard`)."""
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def sum_shards(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The reduce-scatter that transposes :func:`gather_shards`: block i of
    ``x`` along ``dim`` summed over the ranks of ``group`` lands on rank i
    (one all-to-all, the blocks added in rank order)."""
    if n == 1:
        return x
    blocks = x.movedim(dim, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:]).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return out.sum(dim=0).movedim(0, dim)


def gather_blocks(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """:func:`gather_shards` of blocks that differ from rank to rank (an
    all-gather context's K/V), differentiable: each rank's cotangent of
    the gathered tensor is its own, and block i of their sum is rank i's
    gradient (``lax.all_gather``'s transpose, a reduce-scatter)."""
    return with_transpose(x, lambda t: gather_shards(t, dim, group, n),
                          lambda g: sum_shards(g, dim, group, n))
