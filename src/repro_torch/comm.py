"""Transport for the collectives: one exchange per round.

The reference runs every round as one ``lax.ppermute`` under
``shard_map`` (``repro.compat.ppermute`` with the ``_fwd_perm`` /
``_bwd_perm`` permutations of ``repro/core/plan.py``).  Here a round is
one :meth:`shift`: the tensor of rank ``r`` goes to rank ``(r + s) mod p``
(a negative ``s`` is the allgather direction), or one :meth:`permute`
over any fixed set of ``(src, dst)`` pairs (recursive halving's partner
``r ^ d`` is no circulant shift).  Two worlds implement it:

* :class:`LocalComm` — ``p`` virtual ranks in one process on one device.
  Every plan function takes a list of per-rank tensors, one per local
  rank, and the ranks step in lockstep through the plan's round protocol.
  An exchange is an explicit copy (``clone``), so no two ranks ever share
  storage.  A :class:`LocalMesh` of ``D × M`` virtual ranks (data-major,
  the reference's device order) has one ``LocalComm`` per mesh axis: each
  holds all ``D·M`` ranks and exchanges along its axis only, every group
  of that axis in the same lockstep exchange.
* :class:`DistComm` — one rank per process over ``torch.distributed``
  (``batch_isend_irecv``: gloo on the CPU, NCCL on cards, one card a
  process; ``launch.mesh.init_world`` joins the world torchrun started).
  Its lists hold one tensor.  A :class:`DistMesh` has one ``DistComm``
  per mesh axis, each over that axis's process group, every group
  warmed up by one all-reduce as it is made.

``exchanges`` counts one per :meth:`shift` or :meth:`permute` call in
both worlds.  It takes the place of the reference's HLO
collective-permute count, which is the oracle for round counts:
``ceil_log2(p)`` per reduce-scatter and twice that per allreduce.
``bytes`` sums the bytes of every payload an exchange sends from this
process (all its local ranks), standing in for the byte half of
``repro/analysis/hlo_budget.py``: on the int8 wire a round moves
``rows * (cols + 4 * ceil(cols / g))`` bytes per rank.  On a mesh both
count per axis.

The native one-call collectives (:meth:`reduce_scatter_sum`,
:meth:`all_gather`, :meth:`all_reduce_sum`, :meth:`all_to_all`), the
counterparts of the reference's ``psum_scatter`` / ``all_gather`` /
``psum`` / ``all_to_all``, are no collective-permute: they add nothing
to ``exchanges`` or ``bytes`` and count one each in ``natives``.  On a
``LocalComm`` they fold in rank order with elementwise ops, so they are
deterministic and the same bits on the CPU and on a card; on a
``DistComm`` they are ``torch.distributed``'s calls (NCCL's or gloo's
own sums).  :meth:`fold_sum` is the rank-order sum in both worlds, for
the small tensors a step folds over ranks (scalars, tiny leaves, router
statistics): a ``DistComm`` gathers every rank's tensor and folds them
as a ``LocalComm`` does, so a process world gives the in-process
world's bits.  It counts one in ``natives``.

:meth:`shift` and :meth:`permute` are differentiable: under autograd the
backward is the reverse exchange, one more counted exchange, as the
transpose of the reference's ``ppermute`` is the reverse
collective-permute in its HLO.  :meth:`all_reduce_sum` and
:meth:`fold_sum` are differentiable in both worlds (the backward sums
the cotangents, as ``psum`` transposes); over a ``DistComm`` each
process takes the backward of its own loss, and these reverse steps
carry the other ranks' terms.  :meth:`post` starts an exchange and
returns a pending one whose ``wait()`` completes it: on a ``DistComm``
the sends are in flight until then, so a caller can post the next
payload's round before it folds the current one's (the pipelined round
protocol of ``core/plan.py``); a ``LocalComm`` exchanges at once.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing ``cuda`` where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device cuda asked for but torch.cuda.is_available() is False "
            "(pass device='cpu' / --device cpu to run on the CPU)")
    return dev


def _as_pairs(pairs) -> tuple[tuple[int, int], ...]:
    out = tuple((int(s), int(d)) for s, d in pairs)
    if len({s for s, _ in out}) != len(out) or \
            len({d for _, d in out}) != len(out):
        raise ValueError(f"permute pairs must be one-to-one, got {out}")
    return out


def _reverse(route):
    """The route that undoes ``route`` (autograd's backward)."""
    if isinstance(route, int):
        return -route
    return tuple((d, s) for s, d in route)


class _Done:
    """A pending exchange that is already complete."""

    def __init__(self, out: list):
        self._out = out

    def wait(self) -> list[torch.Tensor]:
        return self._out


class _Comm:
    """What both worlds share: the exchange entry points and counters."""

    def shift(self, xs: Sequence[torch.Tensor], s: int) -> list[torch.Tensor]:
        """Rank r's tensor goes to rank (r + s) mod p of its axis group;
        returns what each local rank received (fresh storage)."""
        _check_len(self, xs)
        return _exchange(self, xs, int(s))

    def permute(self, xs: Sequence[torch.Tensor], pairs
                ) -> list[torch.Tensor]:
        """One exchange over fixed ``(src, dst)`` axis-rank pairs: rank
        ``src``'s tensor goes to rank ``dst``; a rank that is no
        destination receives zeros (``lax.ppermute``'s rule)."""
        _check_len(self, xs)
        return _exchange(self, xs, _as_pairs(pairs))

    def fold_sum(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Elementwise sum over each axis group in rank order (``xs[0] +
        xs[1] + ...``), replicated within the group and differentiable:
        the same bits in both worlds."""
        _check_len(self, xs)
        return self._fold(xs)

    def post(self, xs: Sequence[torch.Tensor], s: int):
        """Start :meth:`shift` by ``s``; ``.wait()`` on the result returns
        what :meth:`shift` would.  Counted when posted."""
        _check_len(self, xs)
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return _Done(_exchange(self, xs, int(s)))
        self._count(xs, int(s))
        return self._post(xs, int(s))


class LocalComm(_Comm):
    """``p`` virtual ranks in one process (lists hold ``p`` tensors), or
    one axis of a :class:`LocalMesh`: lists then hold all ``size`` ranks
    of the mesh, and ``ranks[g]`` is rank g's coordinate on this axis,
    ``(g // stride) % p``."""

    def __init__(self, p: int, *, stride: int = 1, size: int | None = None):
        if p < 1:
            raise ValueError(f"p must be >= 1, got {p}")
        size = p if size is None else size
        if stride < 1 or size % (p * stride):
            raise ValueError(f"axis of {p} at stride {stride} does not tile "
                             f"{size} ranks")
        self.p, self.stride, self.size = p, stride, size
        self.ranks = tuple((g // stride) % p for g in range(size))
        self.exchanges = 0
        self.bytes = 0
        self.natives = 0

    def _member(self, g: int, c: int) -> int:
        """The local rank of axis coordinate ``c`` in rank g's group."""
        return g + (c - self.ranks[g]) * self.stride

    def _count(self, xs, route) -> None:
        self.exchanges += 1
        if isinstance(route, int):
            self.bytes += sum(_nbytes(x) for x in xs)
        else:
            senders = {s for s, _ in route}
            self.bytes += sum(_nbytes(x) for x, c in zip(xs, self.ranks)
                              if c in senders)

    def _exchange(self, xs, route) -> list[torch.Tensor]:
        self._count(xs, route)
        return self._move(xs, route)

    def _move(self, xs, route) -> list[torch.Tensor]:
        if isinstance(route, int):
            return [xs[self._member(g, (c - route) % self.p)].clone()
                    for g, c in enumerate(self.ranks)]
        src = {d: s for s, d in route}
        return [xs[self._member(g, src[c])].clone() if c in src
                else torch.zeros_like(xs[g])
                for g, c in enumerate(self.ranks)]

    def _post(self, xs, s: int):
        return _Done(self._move(xs, s))

    def _groups(self) -> list[list[int]]:
        """Every axis group's local ranks, in axis order."""
        return [[self._member(g, k) for k in range(self.p)]
                for g in range(self.size) if self.ranks[g] == 0]

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """Elementwise sum over each axis group, in rank order,
        replicated within the group (differentiable)."""
        _check_len(self, xs)
        self.natives += 1
        out: list = [None] * self.size
        for members in self._groups():
            acc = _fold_sum([xs[m] for m in members])
            for m in members:
                out[m] = acc.clone()
        return out

    def _fold(self, xs):
        return self.all_reduce_sum(xs)

    def reduce_scatter_sum(self, xs: Sequence[torch.Tensor]
                           ) -> list[torch.Tensor]:
        """The native reduce-scatter (``psum_scatter``): each rank's
        ``(n, *rest)`` (n divisible by p) split into p blocks; rank c gets
        block c summed over its group in rank order."""
        _check_len(self, xs)
        self.natives += 1
        out: list = [None] * self.size
        for members in self._groups():
            blocks = [_blocks(xs[m], self.p) for m in members]
            for c, m in enumerate(members):
                out[m] = _fold_sum([b[c] for b in blocks])
        return out

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The native allgather: each rank's ``(blk, *rest)`` to ``(p *
        blk, *rest)`` in rank order, replicated within the group."""
        _check_len(self, xs)
        self.natives += 1
        out: list = [None] * self.size
        for members in self._groups():
            full = torch.cat([xs[m] for m in members])
            for m in members:
                out[m] = full.clone()
        return out

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The native all-to-all: each rank's ``(p, blk, *rest)``, row j
        its payload for rank j, to the same shape with row j the payload
        from rank j."""
        _check_len(self, xs)
        self.natives += 1
        out: list = [None] * self.size
        for members in self._groups():
            for c, m in enumerate(members):
                out[m] = torch.stack([xs[k][c] for k in members])
        return out


class LocalMesh:
    """``D × M`` (any rank) virtual ranks in one process, numbered
    row-major over ``shape`` — for ``("data", "model")`` data-major,
    rank ``d·M + m``, the reference's ``make_mesh`` device order — with
    one :class:`LocalComm` per axis (:meth:`axis`), each counting its own
    exchanges and bytes."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model")):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.size = 1
        for n in self.shape:
            self.size *= n
        self.axes = {}
        stride = self.size
        for name, n in zip(self.axis_names, self.shape):
            stride //= n
            self.axes[name] = LocalComm(n, stride=stride, size=self.size)

    def axis(self, name: str) -> LocalComm:
        """The communicator of axis ``name``."""
        return self.axes[name]


class _Exchange(torch.autograd.Function):
    """A differentiable exchange: the backward is the reverse route.  Over
    a ``DistComm`` it is a cross-process exchange that every rank of the
    group runs, in the same order (each process's backward walks the same
    graph), its cotangent materialized as zeros where its output took no
    gradient: a rank that skipped its half would hang its peers."""

    @staticmethod
    def forward(ctx, comm, route, *xs):
        ctx.comm, ctx.route = comm, route
        return tuple(comm._exchange(xs, route))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.comm._exchange(gs, _reverse(ctx.route)))


def _exchange(comm, xs, route) -> list[torch.Tensor]:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_Exchange.apply(comm, route, *xs))
    return comm._exchange(xs, route)


class _Summed(torch.autograd.Function):
    """A ``DistComm`` op whose output on every rank is the sum over the
    ranks (``op``: :meth:`DistComm._gather_fold` or
    :meth:`DistComm._all_reduce`), so the backward applies the same op to
    the cotangents, the transpose of ``psum``.  It is a collective: each
    rank runs it, zeros or not."""

    @staticmethod
    def forward(ctx, op, x):
        ctx.op = op
        return op(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.op(g)


class _Pending:
    """A posted ``DistComm`` exchange: ``wait()`` completes its sends and
    receives and returns ``[received]``."""

    def __init__(self, works, out: torch.Tensor):
        self._works, self._out = works, out

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        self._works = ()
        return [self._out]


class DistComm(_Comm):
    """One rank of a ``torch.distributed`` process group (lists hold one
    tensor: this process's): the default group, or ``group`` with this
    process's rank in it as its axis coordinate (:class:`DistMesh`)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "DistComm needs torch.distributed.init_process_group first")
        self.group = group
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)
        self.exchanges = 0
        self.bytes = 0
        self.natives = 0

    def _global(self, r: int) -> int:
        """Global rank of this group's rank ``r`` (``P2POp`` peers)."""
        import torch.distributed as dist
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def _count(self, xs, route) -> None:
        self.exchanges += 1
        if isinstance(route, int) or self.rank in {s for s, _ in route}:
            self.bytes += _nbytes(xs[0])

    def _exchange(self, xs, route) -> list[torch.Tensor]:
        self._count(xs, route)
        if isinstance(route, int):
            return self._post(xs, route).wait()
        x = xs[0].contiguous()
        dst = {s: d for s, d in route}.get(self.rank)
        src = {d: s for s, d in route}.get(self.rank)
        return self._start(x, dst, src).wait()

    def _post(self, xs, s: int):
        x = xs[0].contiguous()
        if s % self.p == 0:
            return _Done([x.clone()])
        return self._start(x, (self.rank + s) % self.p,
                           (self.rank - s) % self.p)

    def _start(self, x: torch.Tensor, dst, src):
        """Post the send of ``x`` to axis rank ``dst`` and the receive from
        ``src`` (either may be ``None``) as one ``batch_isend_irecv``."""
        import torch.distributed as dist
        if dst == self.rank and src == self.rank:
            return _Done([x.clone()])
        out = torch.zeros_like(x) if src is None else torch.empty_like(x)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x, self._global(dst),
                                  group=self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, self._global(src),
                                  group=self.group))
        return _Pending(dist.batch_isend_irecv(ops) if ops else [], out)

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """``all_reduce`` (SUM) of this rank's tensor; returns a new one.
        Differentiable: the backward is the all-reduce of the cotangents
        (the transpose of the reference's ``psum``)."""
        _check_len(self, xs)
        self.natives += 1
        if torch.is_grad_enabled() and xs[0].requires_grad:
            return [_Summed.apply(self._all_reduce, xs[0])]
        return [self._all_reduce(xs[0])]

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def _fold(self, xs):
        self.natives += 1
        if torch.is_grad_enabled() and xs[0].requires_grad:
            return [_Summed.apply(self._gather_fold, xs[0])]
        return [self._gather_fold(xs[0])]

    def _gather_fold(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` gathered (the native allgather of the
        flattened tensors), then ``_fold_sum`` in rank order."""
        import torch.distributed as dist
        flat = x.contiguous().reshape(-1)
        out = flat.new_empty(self.p * flat.numel())
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, flat, group=self.group)
        return _fold_sum(list(out.reshape(self.p, *x.shape).unbind(0)))

    def reduce_scatter_sum(self, xs: Sequence[torch.Tensor]
                           ) -> list[torch.Tensor]:
        """``reduce_scatter_tensor`` (SUM) of this rank's ``(n, *rest)``;
        returns its ``(n / p, *rest)`` block."""
        import torch.distributed as dist
        _check_len(self, xs)
        self.natives += 1
        x = xs[0].contiguous()
        out = x.new_empty(_blocks(x, self.p).shape[1:])
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return [out]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``all_gather_single`` (``all_gather_into_tensor`` before torch
        named it so) of this rank's block, in rank order."""
        import torch.distributed as dist
        _check_len(self, xs)
        self.natives += 1
        x = xs[0].contiguous()
        out = x.new_empty((self.p * x.shape[0], *x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, x, group=self.group)
        return [out]

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``all_to_all_single`` of this rank's ``(p, blk, *rest)``."""
        import torch.distributed as dist
        _check_len(self, xs)
        self.natives += 1
        x = xs[0].contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return [out]


class DistMesh:
    """A ``torch.distributed`` world viewed as a mesh of ``shape``
    (row-major over ``axis_names``, data-major for ``("data", "model")``,
    as :class:`LocalMesh` numbers its ranks), with one process group per
    axis line.  Every process must build it, in the same order, after
    ``init_process_group`` with a world of ``prod(shape)``; :meth:`axis`
    returns this process's :class:`DistComm` over that axis."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model")):
        import torch.distributed as dist
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.size = 1
        for n in self.shape:
            self.size *= n
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} needs a world of "
                             f"{self.size}, have {dist.get_world_size()}")
        me = dist.get_rank()
        strides = [self.size // math.prod(self.shape[:i + 1])
                   for i in range(len(self.shape))]
        self.axes = {}
        for i, name in enumerate(self.axis_names):
            others = [range(n) for j, n in enumerate(self.shape) if j != i]
            for coords in itertools.product(*others):
                base = sum(c * strides[j] for j, c in zip(
                    [j for j in range(len(self.shape)) if j != i], coords))
                members = [base + k * strides[i]
                           for k in range(self.shape[i])]
                group = dist.new_group(members)  # collective: every process
                if me in members:
                    _warm_up(group)
                    self.axes[name] = DistComm(group)

    def axis(self, name: str) -> DistComm:
        """This process's communicator on axis ``name``."""
        return self.axes[name]


def _warm_up(group) -> None:
    """One all-reduce on a new group, so that its communicator exists
    before the first point-to-point call (NCCL's batched sends misbehave
    when the first call on a group leaves some of its ranks out)."""
    import torch.distributed as dist
    dev = torch.device("cpu")
    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.all_reduce(torch.zeros(1, device=dev), group=group)


def _blocks(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x``'s leading axis as ``(p, n / p, *rest)``."""
    if x.shape[0] % p:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by axis "
                         f"size {p}; pad first")
    return x.reshape(p, x.shape[0] // p, *x.shape[1:])


def _fold_sum(xs: list[torch.Tensor]) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` in that order, one rounding per add."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc if len(xs) > 1 else acc.clone()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _check_len(comm, xs) -> None:
    if len(xs) != len(comm.ranks):
        raise ValueError(
            f"{type(comm).__name__} holds {len(comm.ranks)} local rank(s), "
            f"got {len(xs)} tensors")
