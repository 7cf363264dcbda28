"""Meshes by their axis sizes, partition specs and their placements:
the port's counterparts of the ``jax.sharding`` types the reference's
spec code uses (``PartitionSpec``, ``AbstractMesh``, ``NamedSharding``).

They are pure values of shapes and axis sizes: nothing here needs a
card or a process group.  ``models/registry.make_param_specs`` builds
specs of these types, and ``launch/mesh.py`` sanitizes them for a mesh
and maps them to DTensor placements and per-rank shapes.
"""
from __future__ import annotations

from dataclasses import dataclass


class PartitionSpec(tuple):
    """How each dim of a tensor is split over mesh axes: one entry per
    leading dim (missing trailing entries are ``None``), each ``None``
    (replicated), an axis name, or a tuple of axis names (the dim split
    over all of them, in order).  A plain tuple:
    ``PartitionSpec("model", None) == ("model", None)``.  As JAX's, an
    entry of one axis is that axis (``("data",)`` is ``"data"``) and an
    empty one is ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_norm_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh by its axis sizes alone: no devices, no process group."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_size(mesh, entry) -> int:
    """The number of ways a spec entry splits its dim on ``mesh``."""
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for e in entry:
            n *= mesh.shape[e]
        return n
    return mesh.shape[entry]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: its DTensor placements and per-rank shapes."""
    mesh: AbstractMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh axis: ``Shard(d)`` where dim d's
        entry names the axis (a dim over several axes is ``Shard(d)`` on
        each of them), else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis = {}
        for d, entry in enumerate(self.spec):
            axes = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            order = [self.mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"dim {d} of {self.spec} splits over {axes} against the "
                    f"mesh's axis order {self.mesh.axis_names}")
            for a in axes:
                if a in by_axis:
                    raise ValueError(f"axis {a!r} shards two dims of "
                                     f"{self.spec}")
                by_axis[a] = Shard(d)
        return tuple(by_axis.get(a, Replicate())
                     for a in self.mesh.axis_names)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One rank's block of a tensor of ``shape`` (every split must
        divide its dim: sanitize the spec first)."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = axis_size(self.mesh, entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{n} ways ({self.spec})")
            out[d] //= n
        return tuple(out)
