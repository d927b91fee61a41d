"""The port's sharding rules, meshes and abstract specs
(``repro_torch.models.params``, ``core.replication``, ``launch.mesh``,
``launch.specs``) against the reference's, on logical meshes.

The reference side builds its meshes with ``compat.abstract_mesh`` (names
and sizes, no devices), the port's are ``LogicalMesh`` records; the specs
must agree leaf by leaf for every assigned architecture on every mesh the
dry run uses, the MRA-factored ones (paper C1) included.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import get_config as ref_config
from repro.core import replication as RR
from repro.core.tiles import default_plan as ref_plan
from repro.launch import specs as RSP
from repro.models import params as RP
from repro.models.layers import AttnOptions as RAttn
from repro.models.transformer import LM as RLM
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import replication as R
from repro_torch.core.tiles import default_plan
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models import params as P
from repro_torch.models.layers import AttnOptions
from repro_torch.models.transformer import LM

MESHES = {
    "1x1": ((1, 1), ("data", "model"), 0),
    "1x2": ((1, 2), ("data", "model"), 0),
    "16x16": ((16, 16), ("data", "model"), 0),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), 0),
    "mra2": ((16, 2, 8), ("data", "replica", "shard"), 2),
    "mra4": ((16, 4, 4), ("data", "replica", "shard"), 4),
}


def _meshes(name):
    shape, names, k = MESHES[name]
    port = R.make_mra_mesh(k) if k else M.LogicalMesh(shape, names)
    assert port.axis_names == names and port.axis_shapes == shape
    return port, abstract_mesh(shape, names), k


def _plans(arch, k):
    plan, rplan = default_plan(get_config(arch)), ref_plan(ref_config(arch))
    if k:                              # the dry run's mra<K>: every tile
        for t in plan.tiles:
            if t.kind in ("attn", "ffn", "moe", "ssm", "shared_attn"):
                plan = plan.with_replication(t.name, k)
                rplan = rplan.with_replication(t.name, k)
    return plan, rplan


def _ref_leaves(tree):
    return [tuple(ps) for ps in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_equal_the_reference(arch, mesh):
    port_mesh, ref_mesh, k = _meshes(mesh)
    plan, rplan = _plans(arch, k)
    rules = R.merged_rules(plan, port_mesh)
    assert rules == RR.merged_rules(rplan, ref_mesh)
    assert R.mra_rules(plan, port_mesh) == RR.mra_rules(rplan, ref_mesh)
    assert R.data_axes(port_mesh, plan) == RR.data_axes(ref_mesh, rplan)
    assert R.data_axes(port_mesh) == RR.data_axes(ref_mesh)

    lm = LM(get_config(arch))
    rlm = RLM(ref_config(arch), opts=RAttn(backend="naive"), remat=False)
    ps = P.pspecs_for(lm.param_specs(), rules, port_mesh)
    rps = RP.pspecs_for(rlm.param_specs(), RR.merged_rules(rplan, ref_mesh),
                        ref_mesh)
    leaves = P.tree_leaves(ps, lambda x: isinstance(x, M.PartitionSpec))
    assert [tuple(p) for p in leaves] == _ref_leaves(rps)
    sh = SP.param_shardings(lm, port_mesh, plan)
    sh_leaves = P.tree_leaves(sh, lambda x: isinstance(x, M.Sharding))
    assert [s.spec for s in sh_leaves] == leaves
    assert all(s.mesh is port_mesh for s in sh_leaves)
    rsh = RSP.param_shardings(rlm, ref_mesh, rplan)
    assert [tuple(s.spec) for s in jax.tree_util.tree_leaves(rsh)] == \
        _ref_leaves(rps)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_partition_spec_for_equals_the_reference(name):
    port_mesh, ref_mesh, _ = _meshes(name)
    rules = {"a": "model", "b": ("data", "model"), "c": "shard",
             "d": ("replica", "shard"), "e": None}
    rules = {k: v for k, v in rules.items()
             if v is None or all(a in port_mesh.axis_names
                                 for a in ((v,) if isinstance(v, str)
                                           else v))}
    for axes in (("a", "e"), ("b", "a"), ("c", "d"), ("d", "c"),
                 ("a", "a"), (None, "b"), ("e", None)):
        axes = tuple(a if a is None or a in rules else None for a in axes)
        for shape in ((32, 64), (6, 10), (1, 16)):
            assert tuple(P.partition_spec_for(axes, shape, rules,
                                              port_mesh)) == \
                tuple(RP.partition_spec_for(axes, shape, rules, ref_mesh))


def test_rule_tables_are_the_reference_s():
    assert P.BASE_RULES == RP.BASE_RULES
    assert P.rules_with({"vocab": None}) == RP.rules_with({"vocab": None})
    assert R.TILE_LOGICAL_AXES == RR.TILE_LOGICAL_AXES


def test_mra_mesh_rules_shard_and_replicate():
    """The reference's MRA case: the ffn tile at K = 2 shards over
    ``shard`` only (replicated over ``replica``), the attention tile at
    K = 1 over both."""
    cfg = get_config("granite-8b")
    plan = default_plan(cfg).with_replication("ffn", 2)
    mesh = M.LogicalMesh((2, 2, 2), ("data", "replica", "shard"))
    rules = R.merged_rules(plan, mesh)
    assert rules["ff"] == "shard"
    assert rules["qkv"] == ("replica", "shard")
    assert R.data_axes(mesh, plan) == ("data", "replica")
    with pytest.raises(AssertionError):
        R.make_mra_mesh(3)
    assert R.make_mra_mesh(4, multi_pod=True).shape == {
        "pod": 2, "data": 16, "replica": 4, "shard": 4}


def test_meshes():
    m = M.make_production_mesh()
    assert (m.axis_names, m.axis_shapes, m.size) == (("data", "model"),
                                                     (16, 16), 256)
    m2 = M.make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16} and m2.size == 512
    for bad in (((2,), ("a", "b")), ((2, 2), ("a", "a")), ((0,), ("a",))):
        with pytest.raises(ValueError):
            M.LogicalMesh(*bad)
    assert M.make_host_mesh("cpu").shape == {"data": 1}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_host_mesh_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_host_mesh()


def test_batch_axes_are_swappable():
    prev = P.get_batch_axes()
    assert prev == RP.get_batch_axes() == ("pod", "data")
    try:
        P.set_batch_axes(("data", "replica"))
        assert P.get_batch_axes() == ("data", "replica")
    finally:
        P.set_batch_axes(prev)


# ------------------------------------- the reference's spec-builder cases
def test_cache_shardings_cover_every_leaf():
    mesh = M.LogicalMesh((1, 1), ("data", "model"))
    for arch in ("granite-8b", "deepseek-v2-lite-16b", "mamba2-370m",
                 "zamba2-7b", "granite-moe-1b-a400m"):
        lm = LM(get_config(arch), opts=AttnOptions(backend="naive"),
                remat=False)
        cache, tok = SP.abstract_decode_inputs(
            lm, ShapeConfig("d", 256, 4, "decode"))
        assert all(t.device.type == "meta"
                   for t in P.tree_leaves(cache, torch.is_tensor))
        sh = SP.cache_shardings(lm, cache, mesh)
        n_abs = len(P.tree_leaves(cache, torch.is_tensor))
        n_sh = len(P.tree_leaves(sh, lambda x: isinstance(x, M.Sharding)))
        assert n_abs == n_sh, (arch, n_abs, n_sh)


def test_cache_shardings_split_batch_and_window():
    mesh = M.make_production_mesh()
    lm = LM(get_config("granite-8b"))
    cache, _ = SP.abstract_decode_inputs(
        lm, ShapeConfig("d", 32768, 128, "decode"))
    sh = SP.cache_shardings(lm, cache, mesh)
    assert tuple(sh["blocks"][0].spec) == (None, ("data",), "model", None,
                                           None)
    # one device holds 1/256 of the KV cache
    kv = sum(t.numel() * t.element_size() for t in cache["blocks"])
    assert SP.per_device_bytes(cache["blocks"], sh["blocks"]) == kv // 256


def test_batch_shardings_fallback_drops_trailing_axes():
    """global_batch < product(batch axes) must fall back, never replicate
    silently (the multi-pod FSDP regression)."""
    mesh = M.LogicalMesh((2, 2, 2), ("pod", "data", "model"))
    batch = {"tokens": torch.empty((4, 8), dtype=torch.int32,
                                   device="meta")}
    sh = SP.batch_shardings(batch, mesh, extra=("model",))
    assert sh["tokens"].spec[0] == ("pod", "data")
    rsh = RSP.batch_shardings(
        {"tokens": jax.ShapeDtypeStruct((4, 8), jnp.int32)},
        abstract_mesh((2, 2, 2), ("pod", "data", "model")), extra=("model",))
    assert tuple(rsh["tokens"].spec) == tuple(sh["tokens"].spec)
    one = SP.batch_shardings({"t": torch.empty((3,), device="meta")}, mesh)
    assert tuple(one["t"].spec) == ()


def test_param_shardings_respect_divisibility():
    mesh = M.LogicalMesh((1, 2), ("data", "model"))
    lm = LM(get_config("phi3-medium-14b"), opts=AttnOptions(backend="naive"),
            remat=False)
    sh = SP.param_shardings(lm, mesh)
    # flattened kv dim 10*128=1280 divides 2 -> sharded
    assert sh["blocks"]["attn"]["wk"].spec[2] == "model"
    # norm scales replicated
    assert sh["final_norm"].spec == M.PartitionSpec(None,)


def test_opt_and_counter_trees():
    cfg = get_config("mamba2-370m")
    lm = LM(cfg)
    mesh = M.make_production_mesh()
    params = lm.abstract()
    opt = SP.abstract_opt_state(params)
    assert opt.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for t in P.tree_leaves(opt.mu, torch.is_tensor))
    psh = SP.param_shardings(lm, mesh)
    osh = SP.opt_shardings(psh, mesh)
    # the moments are float32 twins of the parameters, sharded alike
    f32 = sum(t.numel() * 4 // s.shard_factor() for t, s in zip(
        P.tree_leaves(params, torch.is_tensor),
        P.tree_leaves(psh, lambda x: isinstance(x, M.Sharding))))
    assert SP.per_device_bytes(opt, osh) == 4 + 2 * f32
    ctr = SP.abstract_counters(default_plan(cfg))
    csh = SP.counter_shardings(ctr, mesh)
    assert SP.per_device_bytes(ctr, csh) == 4 * len(
        P.tree_leaves(ctr, torch.is_tensor))
    with pytest.raises(ValueError):
        SP.per_device_bytes(params, csh)


@pytest.mark.parametrize("mesh_shape,names,batch,shape,axes,want", [
    # the reference's DATA / MODEL / MODEL_FULL sites on the production mesh
    ((2, 4), ("data", "model"), None, (8, 16, 64),
     (("pod", "data"), None, "model"), ("data", None, "model")),
    ((2, 4), ("data", "model"), None, (8, 16, 6),         # 6 % 4: dropped
     (("pod", "data"), None, "model"), ("data", None, None)),
    ((2, 4), ("data", "model"), None, (8, 16, 64),
     (("pod", "data"), None, "__model_full__"), ("data", None, "model")),
    # FSDP batch axes: the first dim takes "model", the hidden loses it
    ((2, 4), ("data", "model"), ("data", "model"), (8, 16, 64),
     (("pod", "data"), None, "model"), (("data", "model"), None, None)),
    # ... and drops trailing axes until the batch divides
    ((2, 4), ("data", "model"), ("data", "model"), (2, 16, 64),
     (("pod", "data"), None, "model"), ("data", None, "model")),
    # MRA: model -> shard, MODEL_FULL -> (replica, shard), replica leaves
    # the batch of such a tensor
    ((2, 2, 2), ("data", "replica", "shard"), None, (8, 16, 64),
     (("pod", "data"), None, "model"), ("data", None, "shard")),
    ((2, 2, 2), ("data", "replica", "shard"), ("data", "replica"),
     (8, 16, 64), (("pod", "data"), None, "__model_full__"),
     ("data", None, ("replica", "shard"))),
    ((2, 2, 2), ("data", "replica", "shard"), ("data", "replica"),
     (8, 16, 64), (("pod", "data"), None, "model"),
     (("data", "replica"), None, "shard")),
    # axes the mesh lacks are dropped
    ((4,), ("data",), None, (8, 16, 64), (("pod", "data"), None, "model"),
     ("data", None, None)),
])
def test_activation_spec_follows_the_reference_rules(mesh_shape, names,
                                                     batch, shape, axes,
                                                     want):
    """``params.activation_spec``: the spec the reference's
    ``shard_activation`` constrains to (``repro/models/params.py:184-253``),
    case by case."""
    prev = P.get_batch_axes()
    if batch is not None:
        P.set_batch_axes(batch)
    try:
        got = P.activation_spec(shape, *axes,
                                mesh=M.LogicalMesh(mesh_shape, names))
    finally:
        P.set_batch_axes(prev)
    assert tuple(got) == want


def test_shard_activation_is_the_identity_without_a_process_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert P.shard_activation(x, ("pod", "data"), "model") is x
    with M.set_mesh(M.LogicalMesh((2, 4), ("data", "model"))):
        assert P.shard_activation(x, ("pod", "data"), "model") is x
    assert P.activation_spec((2, 3), "model") is None
