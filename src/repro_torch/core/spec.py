"""`CollectiveSpec` — the declarative half of the plan/execute collective API.

A spec captures everything planning needs (kind, skip schedule, ⊕,
kernel choice) and nothing execution provides (the payload, the
communicator).  Specs are frozen and hashable so ``plan()`` can memoize
on them.

The port implements the circulant kind: uniform blocks, exact or on the
int8 wire (``wire_dtype="int8"``); the flat per-rank ``counts`` of
Corollary 3's non-uniform blocks (``MPI_Reduce_scatter``); and the p×p
per-pair ``counts`` matrix of the ragged alltoallv.  The reference's
other kinds (``broadcast`` and the ring / recursive-halving / xla
baselines) are accepted by name and raise ``NotImplementedError``
pointing at ROADMAP.md's queue 1, so a request for them is never
silently ignored.  Combinations the reference rejects raise
``ValueError`` here too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..kernels.quantize import DEFAULT_GROUP

#: implementation families the reference knows (``repro.core.spec.KINDS``).
KINDS = ("circulant", "broadcast", "ring", "recursive_halving", "xla")

#: the kinds this port can plan.
PORTED_KINDS = ("circulant",)

#: wire formats of the circulant backends (None = uncompressed).
WIRE_DTYPES = (None, "int8")

_TODO = "not ported yet; see ROADMAP.md queue 1"


@dataclass(frozen=True)
class CollectiveSpec:
    """Everything needed to *plan* a collective, nothing needed to run it.

    kind:             implementation family; only ``circulant`` is ported.
    schedule:         Corollary-2 skip schedule name.
    group:            intra-group size for the ``two_level`` schedule.
    op:               reduction ⊕ — ``add``/``max``/``min`` or a callable
                      (the eager backend only; named ops unlock the fused
                      kernel).
    wire_dtype:       ``None`` (exact) or ``"int8"`` (every round's send on
                      the packed ``[codes | scale bytes]`` wire, ~4x fewer
                      bytes, lossy; float payloads and named ops only).
    wire_group:       elements per quantization group on the wire.
    use_fused_kernel: ``None`` = auto (the CUDA kernel when the payload
                      lies on a card), ``True``/``False`` explicit.
    counts:           ``None`` (uniform blocks); a flat per-rank tuple of
                      block row counts (Corollary 3): ``reduce_scatter``
                      takes a ``sum(counts)``-row input and returns a
                      ``max(counts)``-row block, rows past this rank's
                      count zeroed, and ``allgather`` / ``allreduce``
                      invert that layout; or a p×p matrix (tuple of
                      tuples): ``counts[src][dst]`` rows travel from src
                      to dst in the ragged alltoallv.
    """

    kind: str = "circulant"
    schedule: str = "halving"
    group: int | None = None
    op: str | Callable = "add"
    wire_dtype: str | None = None
    wire_group: int = DEFAULT_GROUP
    use_fused_kernel: bool | None = None
    counts: tuple | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; have {KINDS}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown wire_dtype {self.wire_dtype!r}; have {WIRE_DTYPES}")
        if self.wire_group < 1:
            raise ValueError(f"wire_group must be >= 1, got {self.wire_group}")
        if self.kind == "broadcast":
            if self.wire_dtype is not None:
                raise ValueError(
                    "kind='broadcast' distributes payloads bit-exactly; "
                    "wire_dtype compression is not supported")
            if self.use_fused_kernel:
                raise ValueError(
                    "kind='broadcast' has no fold step; the fused round "
                    "kernel does not apply (use_fused_kernel=True invalid)")
        if self.kind not in PORTED_KINDS:
            raise NotImplementedError(f"kind={self.kind!r} is {_TODO}")
        if self.counts is not None:
            rows = list(self.counts)
            if rows and hasattr(rows[0], "__len__"):
                # p×p per-pair matrix (alltoallv): counts[src][dst].
                counts = tuple(tuple(int(c) for c in row) for row in rows)
                if any(len(row) != len(counts) for row in counts):
                    raise ValueError(
                        f"counts matrix must be square (p×p), got row "
                        f"lengths {[len(r) for r in counts]} for "
                        f"{len(counts)} rows")
                flat = [c for row in counts for c in row]
            else:
                counts = tuple(int(c) for c in rows)
                flat = list(counts)
            if any(c < 0 for c in flat):
                raise ValueError(f"counts must be non-negative, got {counts}")
            if sum(flat) == 0:
                raise ValueError(f"counts must have at least one nonzero "
                                 f"entry, got {counts}")
            # Normalized, so specs hash and compare by value (the plan
            # cache's key) whatever the caller's containers and ints.
            object.__setattr__(self, "counts", counts)

    @property
    def counts_matrix(self) -> bool:
        """True when ``counts`` is the p×p per-pair (alltoallv) form."""
        return self.counts is not None and isinstance(self.counts[0], tuple)

    @property
    def wired(self) -> bool:
        """True when the rounds run on a compressed wire."""
        return self.wire_dtype is not None

    @property
    def label(self) -> str:
        """Compact tag (conformance case names), as the reference's."""
        bits = [self.kind, self.schedule]
        if isinstance(self.op, str):
            bits.append(self.op)
        if self.use_fused_kernel:
            bits.append("fused")
        if self.wire_dtype:
            bits.append(f"wire={self.wire_dtype}")
        if self.counts is not None:
            tag = "a2av" if self.counts_matrix else "counts"
            bits.append(f"{tag}={len(self.counts)}")
        return ":".join(bits)


def as_spec(spec_or_kind: "CollectiveSpec | str | None" = None,
            **kw) -> CollectiveSpec:
    """Coerce loose inputs into a ``CollectiveSpec``: an existing spec
    (returned as-is; ``kw`` must be empty), a kind string, or bare
    kwargs."""
    if isinstance(spec_or_kind, CollectiveSpec):
        if kw:
            raise TypeError(
                f"cannot combine an existing CollectiveSpec with extra "
                f"kwargs {sorted(kw)}")
        return spec_or_kind
    if isinstance(spec_or_kind, str):
        kw = dict(kw, kind=spec_or_kind)
    return CollectiveSpec(**kw)
