"""Tensor parallelism over the model axis, ported from
``repro/models/sharding.py``: the activation hooks and the model-axis
calls they stand for.

The reference's hooks only say which layout a tensor must have
(``with_sharding_constraint``); GSPMD inserts the collectives.  The port
has no GSPMD.  A tensor-parallel model runs every local rank of a mesh
together, as the expert-parallel MoE model does: each rank holds its
block of every leaf (the sanitized ``make_param_specs``), an activation
is an :class:`Act` (one tensor per local rank and its layout over the
model axis), and the hooks (:func:`act_btd`, :func:`act_bthd`,
:func:`act_btf`, :func:`act_btv`, with the reference's names and specs)
are where the model-axis calls happen, over the axis's communicator
(``ModelAxis.comm``: a ``LocalComm`` of a ``LocalMesh``, or a
``DistComm`` of a ``DistMesh``).

A layout is ``None`` (replicated: every model rank holds the whole
tensor, and in the backward its whole gradient), ``"P"`` (every rank
holds a partial sum: the output of a matmul whose contracted dim is
sharded) or a dim letter (every rank holds its block of that dim).
:func:`project` reads the sanitized spec of each weight: a matmul whose
contracted dim is sharded ends in a sum over model ranks, one whose
output dim is sharded gives that dim's blocks, and a replicated weight
leaves the layout as it is.  Nothing names which leaves split: a spec
that ``sanitize_spec`` relocated (kv heads that do not divide the axis,
say) takes the path its letters give.

Every rank takes the backward of its own loss (the Megatron-LM
convention): a replicated tensor that enters a rank-local computation
passes through :meth:`ModelAxis.copy` (forward identity, backward the
sum of the ranks' cotangents), a partial sum leaves through
:meth:`ModelAxis.reduce` (forward sum, backward identity).  So every
gradient is one copy's, not the sum of the model ranks' copies of the
loss, and a replicated leaf (a norm gain) gets the same bits on every
model rank.  The native calls (``all_reduce_sum``, ``reduce_scatter_sum``,
``all_gather``, and ``all_to_all`` where :func:`pieces` regroups a split
concatenation, the Mamba heads' ``[x | z]``) are the counterparts of
GSPMD's collectives; they count in the model communicator's
``natives``.

Why not DTensor / ``parallelize_module``, or FSDP2's ``fully_shard``?
Both need one process group per rank, so they cannot run on a
``LocalMesh`` of virtual ranks in one process, which every CPU parity
test and every one-card phase uses (NCCL also refuses two ranks on one
card); and ``fully_shard`` shards dim 0 of ``nn.Module`` parameters,
where the reference shards each functional leaf's own FSDP dim.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from .. import tree as T
from ..sharding import AbstractMesh, NamedSharding, PartitionSpec
from .config import ShardingRecipe

PARTIAL = "P"


def _div_ok(recipe, dim: int) -> bool:
    tp = getattr(recipe, "tp_size", 0)
    return tp == 0 or dim % tp == 0


# ---------------------------------------------------------------------------
# Model-axis calls over per-rank lists, each with its transpose
# ---------------------------------------------------------------------------

def _moved(xs, dim: int) -> list:
    return [x.movedim(dim, 0).contiguous() for x in xs]


def _back(xs, dim: int) -> list:
    return [x.movedim(0, dim) for x in xs]


def all_gather_dim(comm, xs: Sequence[torch.Tensor], dim: int) -> list:
    """The native allgather of each rank's block along ``dim``."""
    return _back(comm.all_gather(_moved(xs, dim)), dim)


def reduce_scatter_dim(comm, xs: Sequence[torch.Tensor], dim: int) -> list:
    """The native reduce-scatter along ``dim`` (each rank its block of
    the sum)."""
    return _back(comm.reduce_scatter_sum(_moved(xs, dim)), dim)


def local_block(comm, xs: Sequence[torch.Tensor], dim: int) -> list:
    """Each local rank's block of ``dim`` (views)."""
    out = []
    for x, c in zip(xs, comm.ranks):
        n = x.shape[dim] // comm.p
        out.append(x.narrow(dim, c * n, n))
    return out


class _Copy(torch.autograd.Function):
    """Forward identity, backward the sum over the axis."""

    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.comm.all_reduce_sum(list(gs)))


class _Reduce(torch.autograd.Function):
    """Forward the sum over the axis, backward identity."""

    @staticmethod
    def forward(ctx, comm, *xs):
        return tuple(comm.all_reduce_sum(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _Scatter(torch.autograd.Function):
    """Forward reduce-scatter along ``dim``, backward allgather."""

    @staticmethod
    def forward(ctx, comm, dim, *xs):
        ctx.comm, ctx.dim = comm, dim
        return tuple(reduce_scatter_dim(comm, xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *all_gather_dim(ctx.comm, gs, ctx.dim))


class _Gather(torch.autograd.Function):
    """Forward allgather along ``dim``, backward reduce-scatter: the
    gathered tensor feeds rank-local computations, whose cotangents are
    partial."""

    @staticmethod
    def forward(ctx, comm, dim, *xs):
        ctx.comm, ctx.dim = comm, dim
        return tuple(all_gather_dim(comm, xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *reduce_scatter_dim(ctx.comm, gs, ctx.dim))


class _AllToAll(torch.autograd.Function):
    """Forward the native all-to-all of every rank's ``(p, blk, ...)``
    payload, backward the same all-to-all of the cotangents (row j went
    to rank j, so its cotangent comes back from rank j)."""

    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(comm.all_to_all(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.comm.all_to_all(list(gs)))


class _GatherWhole(torch.autograd.Function):
    """Forward allgather along ``dim``, backward each rank's own block of
    the (replicated, whole) cotangent."""

    @staticmethod
    def forward(ctx, comm, dim, *xs):
        ctx.comm, ctx.dim = comm, dim
        return tuple(all_gather_dim(comm, xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *local_block(ctx.comm, gs, ctx.dim))


# ---------------------------------------------------------------------------
# Activations and their layouts
# ---------------------------------------------------------------------------

class Act:
    """One tensor per local rank (``xs``), its dims named by letters
    (``dims``, e.g. ``"btd"``) and its ``layout`` over the model axis:
    ``None`` (replicated), ``PARTIAL`` or a letter of ``dims``.  A
    parameter's per-rank blocks are an ``Act`` too."""

    __slots__ = ("xs", "dims", "layout", "_copied")

    def __init__(self, xs, dims: str, layout=None):
        if layout not in (None, PARTIAL) and layout not in dims:
            raise ValueError(f"layout {layout!r} is no dim of {dims!r}")
        self.xs, self.dims, self.layout = list(xs), dims, layout
        self._copied = None

    def dim(self, letter: str) -> int:
        return self.dims.index(letter)

    def whole(self, letter: str, p: int) -> int:
        """Size of dim ``letter`` over all model ranks."""
        n = self.xs[0].shape[self.dim(letter)]
        return n * p if self.layout == letter else n

    def map(self, fn) -> "Act":
        """``fn`` of every rank's tensor, the layout kept."""
        return Act([fn(x) for x in self.xs], self.dims, self.layout)


class ModelAxis:
    """The model axis of a tensor-parallel model: its communicator and
    the recipe (``tp_size`` 0 reads the axis's size)."""

    def __init__(self, comm, recipe: ShardingRecipe):
        self.comm, self.recipe = comm, recipe
        self.p = comm.p
        # a block must divide its dim here, where GSPMD would pad: an
        # unknown size (0) is the axis's
        self.tp_size = recipe.tp_size or comm.p

    # -- the four calls ----------------------------------------------------
    def copy(self, xs) -> list:
        return list(_Copy.apply(self.comm, *xs))

    def reduce(self, xs) -> list:
        return list(_Reduce.apply(self.comm, *xs))

    # -- layout changes ------------------------------------------------------
    def whole(self, a: Act) -> Act:
        """``a`` replicated: a partial sum summed, blocks gathered."""
        if a.layout is None:
            return a
        if a.layout == PARTIAL:
            return Act(self.reduce(a.xs), a.dims)
        return Act(_GatherWhole.apply(self.comm, a.dim(a.layout), *a.xs),
                   a.dims)

    def entering(self, a: Act) -> list:
        """``a``'s whole value as it enters rank-local computations (its
        cotangent a sum over ranks): a replicated tensor through
        :meth:`copy`, blocks through the allgather whose backward is the
        reduce-scatter.  Cached on ``a``: one call however many
        consumers."""
        if a._copied is None:
            w = self.whole(a) if a.layout == PARTIAL else a
            a._copied = (self.copy(w.xs) if w.layout is None else
                         list(_Gather.apply(self.comm, w.dim(w.layout),
                                            *w.xs)))
        return a._copied

    def split(self, a: Act, letter: str) -> Act:
        """``a`` as blocks of dim ``letter``."""
        if a.layout == letter:
            return a
        d = a.dim(letter)
        if a.xs[0].shape[d] % self.p:
            raise ValueError(f"dim {letter!r} of {a.dims!r} ("
                             f"{a.xs[0].shape[d]}) does not divide the "
                             f"model axis ({self.p})")
        if a.layout == PARTIAL:
            return Act(_Scatter.apply(self.comm, d, *a.xs), a.dims, letter)
        if a.layout is not None:
            a = self.whole(a)
        return Act(local_block(self.comm, self.entering(a), d), a.dims,
                   letter)

    def to(self, a: Act, layout) -> Act:
        return self.whole(a) if layout is None else self.split(a, layout)

    def like(self, w: Act, a: Act) -> list:
        """Parameter ``w`` (its dims a suffix of ``a``'s) as ``a``'s
        layout needs it for an elementwise op: whole, the same blocks, or
        whole through :meth:`copy` where ``a`` is split on a dim ``w``
        lacks."""
        if a.layout is None:
            return self.whole(w).xs
        if a.layout == PARTIAL:
            raise ValueError("sum the partial sums before an elementwise op")
        if a.layout in w.dims:
            return self.split(w, a.layout).xs
        return self.entering(w if w.layout is None else self.whole(w))


def pieces(tp: ModelAxis, a: Act, letter: str, n: int, into: str) -> list:
    """``a`` cut into ``n`` equal pieces along dim ``letter`` (the
    reference's ``jnp.split``), each an ``Act`` with that dim renamed
    ``into``.  Where ``a`` is split on ``letter``, rank r's block is a
    run of the concatenation (at M = 2 with two pieces, rank 0 holds all
    of the first and rank 1 all of the second), so one all-to-all
    (:class:`_AllToAll`, backward its transpose) gives every rank its
    own block of every piece: rank r's block is sub-blocks ``r·n ...
    r·n + n - 1`` of the ``n·M`` equal runs, and sub-block k is block
    ``k mod M`` of piece ``k // M``.  Each rank sends its ``n`` sub-blocks
    to ``n`` distinct ranks and zeros to the others (``M - n`` rows of
    its payload; none at M = n).  Any other layout, or pieces that do
    not split evenly, is cut whole."""
    d = a.dim(letter)
    dims = a.dims.replace(letter, into)
    p = tp.p
    if a.layout == letter and p > 1 and (
            n > p or a.whole(letter, p) % (n * p)):
        a = tp.whole(a)
    if a.layout != letter or p == 1:
        if a.layout not in (None, letter):
            a = tp.whole(a)
        lay = into if a.layout == letter else None
        cut = [x.chunk(n, d) for x in a.xs]
        return [Act([c[j] for c in cut], dims, lay) for j in range(n)]
    payloads = []
    for x, r in zip(a.xs, tp.comm.ranks):
        sub = x.movedim(d, 0).unflatten(0, (n, -1))
        rows = [torch.zeros_like(sub[0])] * p
        for j in range(n):
            rows[(r * n + j) % p] = sub[j]
        payloads.append(torch.stack(rows))
    got = _AllToAll.apply(tp.comm, *payloads)
    return [Act([g[(t * p + q) // n].movedim(0, d)
                 for g, q in zip(got, tp.comm.ranks)], dims, into)
            for t in range(n)]


def spec_layout(spec, dims: str, model_axis: str):
    """The letter of ``dims`` a per-layer spec splits over the model axis
    (``None``: replicated over it)."""
    for letter, entry in zip(dims, tuple(spec) + (None,) * len(dims)):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if model_axis in axes:
            return letter
    return None


def project(tp: ModelAxis, x: Act, w: Act, eq: str) -> Act:
    """``einsum(eq, x, w)`` per rank, by the layouts: a weight split on an
    output dim takes ``x`` whole as it enters (:meth:`ModelAxis.entering`)
    and gives that dim's blocks; one split on a contracted dim takes
    ``x``'s blocks of it and gives partial sums; one split on a dim ``x``
    and the output carry too (the experts) takes ``x``'s blocks of it and
    gives the output's; a replicated weight runs
    on ``x`` as it is laid out where that dim survives the product (the
    weight through :meth:`ModelAxis.copy`), else on ``x`` whole."""
    ins, out = eq.split("->")
    xl, wl = ins.split(",")
    lw, lx = w.layout, x.layout

    def run(xs, ws, layout):
        return Act([torch.einsum(eq, a, b) for a, b in zip(xs, ws)], out,
                   layout)

    if lw is None:
        if lx is None:
            return run(x.xs, w.xs, None)
        if lx in out and lx not in wl:
            return run(x.xs, tp.entering(w), lx)
        if lx in wl and lx not in out:
            return run(x.xs, tp.split(w, lx).xs, PARTIAL)
        return run(tp.whole(x).xs, w.xs, None)
    if lw in out and lw not in xl:
        return run(tp.entering(x), w.xs, lw)
    if lw in xl and lw not in out:
        return run(tp.split(x, lw).xs, w.xs, PARTIAL)
    if lw in xl and lw in out:
        # a batch dim both carry (the experts of "ecd,edf->ecf"): each
        # rank runs its own block
        return run(tp.split(x, lw).xs, w.xs, lw)
    return run(tp.whole(x).xs, tp.whole(w).xs, None)


# ---------------------------------------------------------------------------
# The hooks (the reference's names and specs)
# ---------------------------------------------------------------------------

def act_btd(x: Act, tp: ModelAxis) -> Act:
    """(batch, seq, d_model): replicated over the model axis; split on
    seq when sequence-parallel and the sequence divides the axis (GSPMD
    pads an uneven one; the port keeps it whole: the same values).  A
    row-parallel projection's partial sums become one all-reduce (or,
    sequence-parallel, one reduce-scatter on seq)."""
    return tp.to(x, "t" if tp.recipe.sequence_parallel
                 and x.whole("t", tp.p) % tp.p == 0 else None)


def act_bthd(x: Act, tp: ModelAxis) -> Act:
    """(batch, seq, heads, head_dim): heads over the model axis where they
    divide it (``_div_ok``), else whole."""
    return tp.to(x, "h" if _div_ok(tp, x.whole("h", tp.p)) else None)


def act_btf(x: Act, tp: ModelAxis) -> Act:
    """(batch, seq, d_ff): hidden over the model axis where it divides."""
    return tp.to(x, "f" if _div_ok(tp, x.whole("f", tp.p)) else None)


def act_btv(x: Act, tp: ModelAxis) -> Act:
    """(batch, seq, vocab): vocab over the model axis where it divides."""
    return tp.to(x, "v" if _div_ok(tp, x.whole("v", tp.p)) else None)


# ---------------------------------------------------------------------------
# Where each leaf lives: the sanitized specs of a D x M mesh
# ---------------------------------------------------------------------------

#: each leaf's per-layer dims (the letters of :func:`project`'s einsums)
#: by qualified name (``parent.name``, as ``registry._rules`` reads it),
#: else by name: the dense, MoE (``e`` the experts) and VLM families; the
#: Mamba heads (``x`` the in-projection's ``[x | z]`` columns, ``i`` the
#: inner channels, ``n`` the state, ``c`` the conv taps, ``r`` the dt
#: rank), mLSTM and sLSTM (``g`` the four gates, ``j`` the recurrent
#: output dim) and the families' extra norms
LEAF_DIMS = {"embed": "vd", "lm_head": "dv", "final_norm": "d",
             "norm1": "d", "norm2": "d", "wq": "dhk", "wk": "dhk",
             "wv": "dhk", "wo": "hkd", "bq": "hk", "bk": "hk", "bv": "hk",
             "q_norm": "k", "k_norm": "k", "w_gate": "df", "w_up": "df",
             "w_down": "fd", "moe.w_gate": "edf", "moe.w_up": "edf",
             "moe.w_down": "efd", "router": "de", "gate_attn": "",
             "gate_ffn": "",
             "w_in": "dx", "conv_w": "ci", "w_dt": "ir", "dt_bias": "i",
             "w_B": "in", "w_C": "in", "A_log": "in", "D": "i",
             "w_out": "id",
             "wi": "dh", "wf": "dh", "wo_gate": "dhk", "f_bias": "h",
             "i_bias": "h",
             "w_x": "dghk", "r_h": "ghkj", "bias": "ghk",
             "f_bias_extra": "hk",
             "norm_attn_out": "d", "norm_ssm_out": "d", "norm": "d",
             "enc_norm": "d", "norm_x": "d"}


def leaf_dims(path) -> str | None:
    """The per-layer dims of the leaf at ``path`` (``None``: it has no
    tensor-parallel layout)."""
    qual = ".".join(map(str, path[-2:]))
    return LEAF_DIMS.get(qual, LEAF_DIMS.get(path[-1]))


class LeafLayout(NamedTuple):
    """One leaf on a mesh: its sanitized ``spec``, its per-layer ``dims``
    letters, the letter split over the model axis (``model``), the dim
    (of the stored leaf) split over the data axes (``data``, fsdp only)
    and the ``block`` one rank holds."""
    spec: PartitionSpec
    dims: str
    model: str | None
    data: int | None
    block: tuple

    @property
    def model_dim(self) -> int | None:
        """The dim of the stored leaf split over the model axis (``None``:
        replicated over it)."""
        if self.model is None:
            return None
        return len(self.block) - len(self.dims) + self.dims.index(self.model)


class TPLayout(NamedTuple):
    """A model's leaves on a ``(D, M)`` mesh: ``leaves`` a tree of
    :class:`LeafLayout` matching the parameters'."""
    mesh: AbstractMesh
    recipe: ShardingRecipe
    leaves: dict

    def local_shapes(self) -> list:
        """Every leaf's block, flatten order."""
        return [ll.block for ll in T.leaves(self.leaves)]


def tp_layout(cfg, recipe: ShardingRecipe, shape) -> TPLayout:
    """The sanitized specs (``make_param_specs`` under ``recipe``, then
    ``sanitize_specs`` on a ``("data", "model")`` mesh of ``shape``) of
    ``cfg``'s parameters, with each leaf's blocks."""
    from ..launch.mesh import sanitize_specs
    from .registry import make_param_specs, param_shapes
    mesh = AbstractMesh(tuple(shape), tuple(recipe.data_axes)
                        + (recipe.model_axis,))
    shapes = param_shapes(cfg)
    specs = sanitize_specs(mesh, make_param_specs(shapes, recipe), shapes,
                           model_axis=recipe.model_axis)
    data = set(recipe.data_axes)
    out = []
    for (path, spec), (_, shp) in zip(T.flatten(specs), T.flatten(shapes)):
        dims = leaf_dims(path)
        if dims is None:
            raise NotImplementedError(
                f"{cfg.name}: leaf {'.'.join(map(str, path))} has no "
                f"tensor-parallel layout (no entry in LEAF_DIMS)")
        lead = len(shp) - len(dims)
        entries = tuple(spec) + (None,) * (len(shp) - len(spec))
        dsplit = [i for i, e in enumerate(entries)
                  if set(e if isinstance(e, tuple) else (e,)) & data]
        out.append((path, LeafLayout(
            spec=spec, dims=dims,
            model=spec_layout(entries[lead:], dims, recipe.model_axis),
            data=dsplit[0] if dsplit else None,
            block=NamedSharding(mesh, spec).shard_shape(shp))))
    return TPLayout(mesh=mesh, recipe=recipe, leaves=T.unflatten(out))


def leaf_block(x: torch.Tensor, ll: LeafLayout, mesh: AbstractMesh,
               coords: dict, copy: bool = True) -> torch.Tensor:
    """The block of leaf ``x`` (whole) at mesh ``coords`` (axis name to
    coordinate): a copy of its own, or with ``copy=False`` a view."""
    for d, entry in enumerate(tuple(ll.spec)):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        idx, n = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if n > 1:
            blk = x.shape[d] // n
            x = x.narrow(d, idx * blk, blk)
    return x.clone() if copy else x


class TensorParallel(NamedTuple):
    """What a tensor-parallel model runs on: the model axis
    (:class:`ModelAxis`), the data axis's communicator (its
    coordinates place each rank's blocks; it gathers the leaves split
    over the data axes, fsdp_auto's ``tp_fsdp``) and the leaves'
    :class:`TPLayout`.  ``pooled`` is fsdp_auto's: its data axis is
    GSPMD's in the reference, so a computation over the whole batch
    (the MoE's global token pool) spans every data rank's rows; zero1's
    data axis is manual, each data rank its own pool."""
    axis: Any
    data: Any
    layout: Any
    pooled: bool = False

    def coords(self) -> list:
        """Every local rank's mesh coordinates (axis name to index)."""
        names = self.layout.mesh.axis_names
        return [dict(zip(names, dm))
                for dm in zip(self.data.ranks, self.axis.comm.ranks)]

    def blocks(self, path, leaf) -> list:
        """Every local rank's block of the whole leaf at ``path``, each a
        copy of its own."""
        ll = T.get(self.layout.leaves, path)
        return [leaf_block(leaf, ll, self.layout.mesh, c)
                for c in self.coords()]
