"""The spec half of tensor parallelism (``ShardingRecipe``,
``make_param_specs``, ``launch/mesh.py``'s specs) against the
reference's, in process: no devices on either side (the reference's
meshes are ``jax.sharding.AbstractMesh``, the port's ``AbstractMesh``).

* for all ten configs at full size (the reference's trees through
  ``jax.eval_shape``, the port's through ``param_shapes``) the
  sanitized spec trees equal the reference's leaf by leaf, on the
  (16, 16), (2, 16, 16) and a small (4, 2) mesh, under the ``tp`` and
  ``tp_fsdp`` recipes;
* ``best_effort_cache_spec`` equals the reference's on each family's
  cache shapes, and ``sanitize_spec``'s model-axis relocation on edge
  shapes;
* the DTensor placements and the per-rank shapes follow from the specs:
  the per-rank shapes are the reference's ``NamedSharding.shard_shape``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as RefMesh
from jax.sharding import NamedSharding as RefNamed
from jax.sharding import PartitionSpec as RefP

from repro.configs import ALIASES, get_config
from repro.launch import mesh as ref_mesh
from repro.models import ShardingRecipe as RefRecipe
from repro.models import build as ref_build
from repro.models import make_param_specs as ref_specs
from repro_torch import tree as T
from repro_torch.configs import get_config as port_config
from repro_torch.launch import mesh
from repro_torch.sharding import AbstractMesh, NamedSharding
from repro_torch.sharding import PartitionSpec as P
from repro_torch.models import (ShardingRecipe, leaf_dtype, make_param_specs,
                                param_shapes)
from repro_torch.models.transformer import init_cache
from repro_torch.models.xlstm import init_cache as xlstm_cache

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]
MODES = ("tp", "tp_fsdp")


def _path(path) -> tuple:
    return tuple(k.idx if isinstance(k, jax.tree_util.SequenceKey)
                 else k.key for k in path)


def _ref_tree(tree) -> list:
    return [(_path(p), tuple(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, RefP))[0]]


def _data_axes(axes) -> tuple:
    return tuple(a for a in axes if a != "model")


def _port_specs(arch, sizes, axes, mode):
    shapes = param_shapes(port_config(arch))
    m = AbstractMesh(sizes, axes)
    recipe = ShardingRecipe(data_axes=_data_axes(axes), mode=mode)
    return m, shapes, mesh.sanitize_specs(
        m, make_param_specs(shapes, recipe), shapes)


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_sanitized_spec_trees_equal_reference(arch):
    """Full size, every mesh and recipe: the unsanitized and the
    sanitized trees, leaf by leaf, in the same leaf order."""
    full = get_config(arch)
    shapes = jax.eval_shape(ref_build(full, recipe=None).init,
                            jax.random.PRNGKey(0))
    for sizes, axes in MESHES:
        jm = RefMesh(sizes, axes)
        for mode in MODES:
            raw = ref_specs(shapes, RefRecipe(data_axes=_data_axes(axes),
                                              mode=mode))
            want = ref_mesh.sanitize_specs(jm, raw, shapes)
            m, pshapes, got = _port_specs(arch, sizes, axes, mode)
            recipe = ShardingRecipe(data_axes=_data_axes(axes), mode=mode)
            assert [(p, tuple(s)) for p, s in T.flatten(
                make_param_specs(pshapes, recipe))] == _ref_tree(raw)
            assert [(p, tuple(s)) for p, s in T.flatten(got)] == \
                _ref_tree(want), (arch, sizes, mode)
    assert all(s == P() for s in T.leaves(make_param_specs(pshapes, None)))


def _ref_caches(arch, batch=32, seq=1024):
    """Leaf shapes of the reference's full-size prefill cache."""
    cfg = get_config(arch)
    model = ref_build(cfg, recipe=None)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    dec = min(cfg.dec_len, seq) if cfg.family == "encdec" else seq
    ex = {}
    if cfg.family == "encdec":
        ex["frames"] = jax.ShapeDtypeStruct((batch, seq, cfg.d_model),
                                            jnp.bfloat16)
    if cfg.family == "vlm":
        ex["image_embeds"] = jax.ShapeDtypeStruct(
            (batch, cfg.n_image_tokens, cfg.d_model), jnp.bfloat16)
    cache, _ = jax.eval_shape(
        lambda p, t, e: model.prefill(p, t, seq, **e), params,
        jax.ShapeDtypeStruct((batch, dec), jnp.int32), ex)
    return [tuple(x.shape) for x in jax.tree.leaves(cache)]


def test_best_effort_cache_spec_equals_reference():
    """Each family's cache shapes (the reference's at full size; the
    port's own caches of the same families, built on the meta device,
    have the same shapes), on every mesh, batch over the data axes."""
    fams = set()
    for arch in sorted(ALIASES):
        cfg = port_config(arch)
        shapes = _ref_caches(arch)
        if cfg.family in ("dense", "moe", "hybrid", "ssm_xlstm"):
            build_cache = (xlstm_cache if cfg.family == "ssm_xlstm"
                           else init_cache)
            own = [y for x in T.leaves(build_cache(cfg, 32, 1024,
                                                   device="meta"))
                   for y in (x if isinstance(x, tuple) else (x,))]
            assert sorted(tuple(x.shape) for x in own) == sorted(shapes)
        for sizes, axes in MESHES:
            jm, pm = RefMesh(sizes, axes), AbstractMesh(sizes, axes)
            for shape in shapes + [(32,), (7, 5), (64, 32, 16)]:
                for batch in (32, 64):
                    want = ref_mesh.best_effort_cache_spec(
                        jm, shape, batch, _data_axes(axes), "model")
                    got = mesh.best_effort_cache_spec(
                        pm, shape, batch, _data_axes(axes), "model")
                    assert tuple(got) == tuple(want), (arch, shape, sizes)
        fams.add(cfg.family)
    assert len(fams) == 6


def test_sanitize_spec_edges_equal_reference():
    """Undivided dims dropped, size-1 axes kept, the model axis relocated
    to the largest divisible unsharded dim (or nowhere), short and long
    specs, fallback off."""
    cases = [(("model", None, None), (8, 4096, 512)),
             ((None, "model"), (12, 64)),
             ((None, "model", None), (3, 12, 7)),
             ((("pod", "data"), "model"), (64, 30)),
             ((("data", "model"),), (256, 3)),
             (("data",), (48, 16, 2)),
             (("model", "data", None, None), (4, 16)),
             ((), (16, 16)),
             ((None, None, "model"), (32, 32, 8))]
    for sizes, axes in MESHES + [((1, 16), ("data", "model"))]:
        jm, pm = RefMesh(sizes, axes), AbstractMesh(sizes, axes)
        for spec, shape in cases:
            if any(a not in axes for e in spec for a in
                   (e if isinstance(e, tuple) else (e,)) if a):
                continue
            for fallback in (True, False):
                want = ref_mesh.sanitize_spec(jm, RefP(*spec), shape,
                                              fallback=fallback)
                got = mesh.sanitize_spec(pm, P(*spec), shape,
                                         fallback=fallback)
                assert tuple(got) == tuple(want), (sizes, spec, shape)


def test_partition_spec_and_production_mesh():
    """A plain tuple normalized as JAX's; the production meshes by axis
    sizes; the recipe's axes."""
    assert P("model", None) == ("model", None)
    assert tuple(P(("data",), (), ("pod", "data"), None)) == \
        tuple(RefP(("data",), (), ("pod", "data"), None))
    assert repr(P("data", None)) == "P('data', None)"
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        want = RefMesh((2, 16, 16) if multi else (16, 16),
                       ("pod", "data", "model") if multi
                       else ("data", "model"))
        assert m.shape == dict(want.shape) and m.axis_names == \
            want.axis_names
    r = ShardingRecipe(data_axes=("pod", "data"), mode="tp_fsdp")
    ref = RefRecipe(data_axes=("pod", "data"), mode="tp_fsdp")
    assert (r.batch_axes, r.fsdp_axes) == (ref.batch_axes, ref.fsdp_axes)
    assert ShardingRecipe().fsdp_axes == RefRecipe().fsdp_axes == ()


def test_placements_follow_specs():
    """One placement per mesh axis: ``Shard(d)`` where dim d names the
    axis, one on each axis of a multi-axis dim, else ``Replicate()``; a
    dim whose axes run against the mesh's order, or an axis used twice,
    is refused."""
    from torch.distributed.tensor import Replicate, Shard
    m = mesh.make_production_mesh(multi_pod=True)
    specs = {"a": P(("pod", "data"), "model"), "b": P(None, "model"),
             "c": P(), "d": P("data", None, "model")}
    got = mesh.named(m, specs)
    assert got["a"].placements == (Shard(0), Shard(0), Shard(1))
    assert got["b"].placements == (Replicate(), Replicate(), Shard(1))
    assert got["c"].placements == (Replicate(),) * 3
    assert got["d"].placements == (Replicate(), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="axis order"):
        NamedSharding(m, P(("data", "pod"))).placements
    with pytest.raises(ValueError, match="two dims"):
        NamedSharding(m, P("model", "model")).placements
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(m, P("model")).shard_shape((12,))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama-3.2-vision-90b"])
def test_per_rank_shapes_follow_specs(arch):
    """``struct_with_sharding``: every leaf's per-rank block as a meta
    tensor of its dtype, the shape the reference's ``NamedSharding``
    gives on the same abstract mesh and spec."""
    for sizes, axes in MESHES:
        jm = RefMesh(sizes, axes)
        for mode in MODES:
            m, shapes, specs = _port_specs(arch, sizes, axes, mode)
            cfg = port_config(arch)
            full = T.unflatten(
                (p, torch.empty(s, dtype=leaf_dtype(cfg, p), device="meta"))
                for p, s in T.flatten(shapes))
            per = mesh.struct_with_sharding(full, mesh.named(m, specs))
            for (path, x), (_, spec), (_, s) in zip(
                    T.flatten(per), T.flatten(specs), T.flatten(shapes)):
                assert x.device.type == "meta"
                assert x.dtype == leaf_dtype(cfg, path)
                want = RefNamed(jm, RefP(*spec)).shard_shape(s)
                assert tuple(x.shape) == tuple(want), (path, spec)
