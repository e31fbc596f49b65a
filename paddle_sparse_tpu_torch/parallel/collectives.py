"""The collectives of the sharded kernels, each a ``torch.autograd.Function``
whose backward is the transpose that JAX gives the same collective.

``torch.distributed.nn.functional`` is not used: its ``all_gather`` backward
sums the gradient over ranks, which is not ``all_gather``'s transpose.

* :func:`all_gather`, JAX's ``all_gather(tiled=True)``: forward
  ``all_gather_into_tensor``, backward ``reduce_scatter_tensor`` (sum);
* :func:`reduce_scatter`, ``psum_scatter(tiled=True)``: forward
  ``reduce_scatter_tensor`` (sum), backward ``all_gather_into_tensor``;
* :func:`all_to_all`, ``all_to_all(tiled=False)`` along axis 0: forward and
  backward ``all_to_all_single``;
* :func:`ring_shift`, the ``ppermute`` ring ``i -> i + 1``: forward
  ``batch_isend_irecv``, backward the same ring the other way.

Each backward calls its sibling Function (all-gather and reduce-scatter,
all-to-all itself, the ring and its reverse), so under ``create_graph`` the
gradient stays in the graph and a sharded step differentiates at any order,
as JAX's collectives transpose at any order.

Each takes rows along dim 0 and a process group; ranks are the group's. The
tensors stay where they are: a group whose backend cannot take them raises.
"""
import torch
import torch.distributed as dist

# the current names of the single-tensor collectives (older torch has only
# the *_tensor names)
_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)
_reduce_scatter_into = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_into(out, x.contiguous(), group=group)
    return out


def _scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not divide over {world} "
                         f"ranks")
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    _reduce_scatter_into(out, x.contiguous(), op=dist.ReduceOp.SUM,
                         group=group)
    return out


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to group rank ``r + step`` and receive from ``r - step``
    (mod the group size)."""
    world, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    to = dist.get_global_rank(group, (r + step) % world)
    src = dist.get_global_rank(group, (r - step) % world)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _RingShift(torch.autograd.Function):
    """The ring ``r -> r + step``; its transpose is the ring ``-step``."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _RingShift.apply(g, ctx.group, -ctx.step), None, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (``(world * n,
    ...)``); the backward sums each rank's slice of the cotangent over the
    ranks and hands it to its owner."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``x`` (``(world * n, ...)``), rank ``r`` keeping
    rows ``r * n .. (r + 1) * n - 1``; the backward all-gathers."""
    return _ReduceScatter.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of ``(world, ...)``: slab ``j`` goes to rank ``j``; slab ``s``
    of the result came from rank ``s``. Its own transpose."""
    return _AllToAll.apply(x, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank ``r``'s ``x`` to rank ``r + 1`` (mod the group size): the result
    is rank ``r - 1``'s. The backward shifts the cotangent the other way. On
    a group of one rank it is ``x`` itself (no rank sends to itself)."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group, 1)
