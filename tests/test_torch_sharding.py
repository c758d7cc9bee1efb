"""The port's sharding rules, mesh topology, configs' sharding presets and
elastic mesh shapes, held against the reference's own functions on the
same inputs. One process, no ranks: the port's meshes are DeviceMeshes
over torch's in-process "fake" process group (shapes without devices);
the reference's rules run on a 1 x 1 jax mesh of the same axis names (the
rules prune by name) or on its shape alone."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as j_base
from repro.core import autotune as j_autotune
from repro.core import meshspec as j_meshspec
from repro.core import planner as j_planner
from repro.core.pipeline_model import Workload as JWorkload
from repro.models import build_model as j_build
from repro.runtime import elastic as j_elastic
from repro.runtime import sharding as j_sh
from repro_torch.configs import base as t_base
from repro_torch.core import autotune as t_autotune
from repro_torch.core import meshspec as t_meshspec
from repro_torch.core import planner as t_planner
from repro_torch.core.pipeline_model import Workload as TWorkload
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import opt_state_axes, shardings_for_cell
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as L
from repro_torch.runtime import elastic as t_elastic
from repro_torch.runtime import sharding as t_sh

WORLD = 512


@pytest.fixture(scope="module")
def fake_world():
    """A 512-rank fake process group in this process (meshes of any shape
    up to the multi-pod one), torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    yield
    dist.destroy_process_group()


def _t_mesh(shape, names):
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _j_ctx(names, overrides, sizes):
    """The reference's pruned rules (its use_sharding on a 1 x .. x 1 mesh
    of these axis names), in a context whose mesh has ``sizes``."""
    mesh = jax.make_mesh((1,) * len(names), names)
    with j_sh.use_sharding(mesh, overrides=overrides) as ctx:
        rules = dict(ctx.rules)
    return j_sh.ShardingContext(
        mesh=types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                   axis_names=names), rules=rules)


MESHES = [((4, 2), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((8,), ("data",))]
OVERRIDES = [None, {"kv_heads": None}, {"heads": None, "kv_heads": None,
                                        "seq": "model"},
             {"expert": None, "exp_cap": "data", "kv_heads": None},
             {"batch": None, "kv": "data", "seq": None, "state": None}]


def _all_axes():
    """Every logical-axes tuple the reference's smoke models use (params,
    train inputs, decode caches), and a few by hand."""
    out = {("batch", "seq", "embed"), ("batch", "seq", "vocab"),
           ("batch", "seq", "heads", None), ("batch", "kv", "kv_heads", None),
           ("expert", "exp_cap", "embed"), ("batch", None, "embed"),
           ("heads", "mlp"), ("batch", "batch"), (None,), ()}
    leaf = lambda x: isinstance(x, tuple)        # noqa: E731
    for arch in j_base.ARCH_IDS:
        cfg = j_base.smoke_config(arch)
        if arch == "deepseek_v2_lite_16b":
            cfg = cfg.replace(attn_impl="xla")
        m = j_build(cfg)
        out.update(jax.tree.leaves(m.param_axes(), is_leaf=leaf))
        out.update(jax.tree.leaves(
            m.input_axes(j_base.SHAPES["train_4k"]), is_leaf=leaf))
        out.update(jax.tree.leaves(
            m.cache_spec(j_base.SHAPES["decode_32k"])[1], is_leaf=leaf))
    return sorted(out, key=repr)


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("shape,names", MESHES)
def test_rules_prune_and_specs_match_reference(fake_world, shape, names,
                                               overrides):
    jctx = _j_ctx(names, overrides, shape)
    with t_sh.use_sharding(_t_mesh(shape, names), overrides=overrides) as tc:
        assert tc.rules == jctx.rules
        assert tc.data_shards() == jctx.data_shards()
        for name in names:
            assert tc.axis_size(name) == jctx.axis_size(name)
        for axes in _all_axes():
            want = tuple(j_sh.spec_for(axes, jctx))
            assert t_sh.partition_spec(axes) == want, axes
            # placements: Shard(d) on each mesh axis dim d goes to
            placements = t_sh.spec_for(axes)
            expect = [Replicate() for _ in names]
            for d, part in enumerate(want):
                for a in ((part,) if isinstance(part, str) else part or ()):
                    expect[names.index(a)] = Shard(d)
            assert placements == tuple(expect), axes
        for logical in t_sh.DEFAULT_RULES:
            for size in (1, 2, 6, 8, 16, 48):
                assert t_sh.divisible(logical, size) == \
                    j_sh.divisible(logical, size, jctx), (logical, size)


def test_no_context_is_a_no_op():
    x = torch.ones(2, 3)
    assert t_sh.current() is None
    assert t_sh.constrain(x, ("batch", "embed")) is x
    assert t_sh.spec_for(("batch",)) == () == tuple(j_sh.spec_for(("batch",)))
    assert t_sh.divisible("heads", 7) and j_sh.divisible("heads", 7)
    assert t_sh.tree_shardings({"a": ("batch",), "b": {"c": ()}}) == \
        {"a": None, "b": {"c": None}}
    assert t_sh.place_tree({"a": x}, {"a": ("batch", None)})["a"] is x


def test_constrain_checks_rank_under_a_context(fake_world):
    with t_sh.use_sharding(_t_mesh((4, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="rank-2"):
            t_sh.constrain(torch.ones(2, 3), ("batch",))
        x = torch.ones(2, 3)             # a rank's local shard: as it is
        assert t_sh.constrain(x, ("batch", "embed")) is x


@pytest.mark.parametrize("arch", t_base.ARCH_IDS)
def test_tree_shardings_of_models_match_reference(fake_world, arch):
    jcfg, tcfg = j_base.get_config(arch), t_base.get_config(arch)
    names, shape = ("data", "model"), (4, 2)
    jctx = _j_ctx(names, jcfg.rule_overrides, shape)
    over = dict(j_base.SHAPES["decode_32k"].rule_overrides)
    jctx_dec = _j_ctx(names, {**(jcfg.rule_overrides or {}), **over}, shape)
    jm = j_build(jcfg.replace(attn_impl="xla"))
    tm = t_build(tcfg.replace(attn_impl="xla"))
    mesh = _t_mesh(shape, names)
    leaf = lambda x: isinstance(x, tuple)        # noqa: E731

    def specs(tree):
        return [tuple(s) for s in jax.tree.leaves(
            jax.tree.map(lambda ax: j_sh.spec_for(ax, jctx), tree,
                         is_leaf=leaf), is_leaf=leaf)]

    with t_sh.use_sharding(mesh, overrides=tcfg.rule_overrides) as ctx:
        cell = shardings_for_cell(tm, t_base.SHAPES["train_4k"], ctx,
                                  optimizer=tcfg.optimizer)
        got = [s.placements for s in jax.tree.leaves(
            cell["params"], is_leaf=lambda x: hasattr(x, "placements"))]
        want = [t_sh.spec_for(ax) for ax in jax.tree.leaves(
            jm.param_axes(), is_leaf=leaf)]
        assert got == want
        assert [t_sh.partition_spec(ax) for ax in jax.tree.leaves(
            tm.param_axes(), is_leaf=leaf)] == specs(jm.param_axes())
        assert jax.tree.structure(cell["opt"], is_leaf=lambda x: hasattr(
            x, "placements")).num_leaves == len(jax.tree.leaves(
                opt_state_axes(tcfg.optimizer, tm.param_axes()),
                is_leaf=leaf))
        assert tm.input_axes(t_base.SHAPES["train_4k"]) == \
            jm.input_axes(j_base.SHAPES["train_4k"])
    with t_sh.use_sharding(mesh, overrides={**(tcfg.rule_overrides or {}),
                                            **over}):
        t_axes = tm.cache_spec(t_base.SHAPES["decode_32k"])[1]
        j_axes = jm.cache_spec(j_base.SHAPES["decode_32k"])[1]
        assert [t_sh.partition_spec(ax) for ax in jax.tree.leaves(
            t_axes, is_leaf=leaf)] == [tuple(j_sh.spec_for(ax, jctx_dec))
                                       for ax in jax.tree.leaves(
                                           j_axes, is_leaf=leaf)]


@pytest.mark.parametrize("arch", t_base.ARCH_IDS)
def test_configs_rule_overrides_match_reference(arch):
    assert t_base.get_config(arch).rule_overrides == \
        j_base.get_config(arch).rule_overrides
    assert t_base.smoke_config(arch).rule_overrides == \
        j_base.smoke_config(arch).rule_overrides


def test_shapes_and_applicability_match_reference():
    assert set(t_base.SHAPES) == set(j_base.SHAPES)
    for name, js in j_base.SHAPES.items():
        ts = t_base.SHAPES[name]
        assert (ts.name, ts.seq_len, ts.global_batch, ts.kind,
                ts.rule_overrides) == (js.name, js.seq_len, js.global_batch,
                                       js.kind, js.rule_overrides)
        for arch in t_base.ARCH_IDS:
            tc, jc = t_base.get_config(arch), j_base.get_config(arch)
            assert tc.sub_quadratic == jc.sub_quadratic
            assert t_base.shape_applicable(tc, ts) == \
                j_base.shape_applicable(jc, js)


def test_mesh_spec_and_localization_match_reference(fake_world):
    mesh = _t_mesh((4, 2), ("data", "model"))
    duck = types.SimpleNamespace(shape={"data": 4, "model": 2})
    spec = t_meshspec.MeshSpec.from_mesh(mesh)
    assert spec.axes == j_meshspec.MeshSpec.from_mesh(duck).axes
    assert spec.token == "data4.model2" and spec.device_count == 8
    for n_words, shards in ((1, 1), (7, 2), (64, 8), (65, 8), (3, 4)):
        tw = TWorkload(n_words=n_words, word_bytes=4096.0,
                       flops_per_word=1e6)
        jw = JWorkload(n_words=n_words, word_bytes=4096.0,
                       flops_per_word=1e6)
        assert t_meshspec.localize_workload(tw, shards).n_words == \
            j_meshspec.localize_workload(jw, shards).n_words
    # resolve_sharding: none, a context, a bare spec, a spec under the
    # same ambient context
    assert t_meshspec.resolve_sharding() == (t_meshspec.SINGLE_DEVICE, 1)
    assert t_meshspec.resolve_mesh(None) == t_meshspec.SINGLE_DEVICE
    jctx = _j_ctx(("data", "model"), None, (4, 2))
    bare = t_meshspec.MeshSpec(axes=(("data", 4),))
    jbare = j_meshspec.MeshSpec(axes=(("data", 4),))
    assert t_meshspec.resolve_sharding(bare) == (bare, 4)
    assert j_meshspec.resolve_sharding(jbare)[1] == 4
    with t_sh.use_sharding(mesh) as ctx:
        got = t_meshspec.resolve_sharding(ctx)
        want = j_meshspec.resolve_sharding(jctx)
        assert (got[0].axes, got[1]) == (want[0].axes, want[1])
        assert t_meshspec.resolve_sharding(spec) == (spec, 4)
        assert t_meshspec.resolve_sharding() == (spec, 4)
        assert t_meshspec.ambient_mesh() == spec
        assert t_meshspec.resolve_mesh(None) == spec
        assert ctx.mesh_spec() == spec


def test_production_and_host_mesh_shapes(fake_world):
    assert mesh_lib.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert mesh_lib.production_mesh_shape(True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    m = mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    assert t_sh.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 256 ranks.*has 512"):
        mesh_lib.make_production_mesh(device_type="cpu")
    mesh_lib.check_production_world(256)
    with pytest.raises(ValueError, match="needs 512 ranks.*has 8"):
        mesh_lib.check_production_world(8, multi_pod=True)
    for world, want in ((1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (8, (4, 2)),
                        (256, (128, 2))):
        assert mesh_lib.host_mesh_shape(world) == (want, ("data", "model"))
    assert t_sh.mesh_shape(mesh_lib.make_host_mesh()) == \
        {"data": 256, "model": 2}


@pytest.mark.parametrize("n,model_axis,pod_axis,match", [
    (7, 2, 1, "cannot host model_axis=2"),
    (8, 2, 3, "pod_axis=3"),
])
def test_survivable_mesh_errors_match_reference(n, model_axis, pod_axis,
                                                match):
    devs = list(jax.devices()) * n
    with pytest.raises(ValueError, match=match):
        j_elastic.survivable_mesh(devs, model_axis, pod_axis=pod_axis)
    with pytest.raises(ValueError, match=match):
        t_elastic.survivable_mesh(list(range(n)), model_axis,
                                  pod_axis=pod_axis)


def test_survivable_mesh_shapes(fake_world):
    """The reference's test_survivable_mesh_pod_axis_shapes cases."""
    m = t_elastic.survivable_mesh(range(8), model_axis=2, pod_axis=2)
    assert t_sh.mesh_shape(m) == {"pod": 2, "data": 2, "model": 2}
    assert m.mesh_dim_names == ("pod", "data", "model")
    m = t_elastic.survivable_mesh(range(8), model_axis=2)
    assert t_sh.mesh_shape(m) == {"data": 4, "model": 2}
    m = t_elastic.survivable_mesh(range(4), model_axis=4, pod_axis=1)
    assert t_sh.mesh_shape(m) == {"data": 1, "model": 4}
    assert isinstance(m, DeviceMesh)
    assert m.mesh.flatten().tolist() == [0, 1, 2, 3]


def _populate(planner, autotune, meshspec, wl_cls, dtype, hw):
    """Three plans and three tuned records each under a single-device, a
    data4.model2 and a data2.model2 topology."""
    meshes = [meshspec.SINGLE_DEVICE,
              meshspec.MeshSpec(axes=(("data", 4), ("model", 2))),
              meshspec.MeshSpec(axes=(("data", 2), ("model", 2)))]
    planner.plan_cache_clear()
    autotune.tuned_cache_clear()
    for mesh in meshes:
        for n in (8, 16, 32):
            w = wl_cls(n_words=n, word_bytes=1024.0, flops_per_word=8192.0)
            planner.planned_pipe("ff_matmul", w, (16, 16, 16), dtype,
                                 hw, mesh=mesh)
            key = autotune.plan_key("ff_matmul", w, dtype, hw, mesh=mesh)
            autotune._MEM[("cache.json", key)] = {"depth": 2, "streams": 1,
                                                  "mesh": mesh.token}
    return meshes


def test_plan_invalidation_counts_match_reference():
    t_meshes = _populate(t_planner, t_autotune, t_meshspec, TWorkload,
                         torch.bfloat16, t_planner.H100_SXM)
    j_meshes = _populate(j_planner, j_autotune, j_meshspec, JWorkload,
                         jnp.bfloat16, j_planner.TPU_V5E)
    try:
        assert t_planner.plan_cache_info().currsize == 9
        got = (t_planner.invalidate_mesh_plans(t_meshes[2]),
               t_autotune.invalidate_mesh(t_meshes[2]))
        want = (j_planner.invalidate_mesh_plans(j_meshes[2]),
                j_autotune.invalidate_mesh(j_meshes[2]))
        assert got == want == (3, 3)
        assert t_planner.plan_cache_info().currsize == 6
        assert t_planner.last_plan("ff_matmul").mesh == t_meshes[2]
        # keep_single=False drops the single-device entries too
        assert t_planner.invalidate_mesh_plans(
            t_meshes[2], keep_single=False) == 3
        assert t_autotune.invalidate_mesh(t_meshes[2],
                                          keep_single=False) == 3
    finally:
        t_planner.plan_cache_clear()
        t_autotune.tuned_cache_clear()
        j_planner.plan_cache_clear()
        j_autotune.tuned_cache_clear()


def test_init_params_places_each_leaf_as_model_init(fake_world):
    """Under a mesh the trainer draws each leaf whole and keeps its shard:
    the same bits as model.init, leaf by leaf (the fake group's ranks all
    read as rank 0, so rank 0's shard is checked)."""
    from repro_torch.launch.steps import init_params
    cfg = t_base.smoke_config("llama3_2_1b").replace(attn_impl="xla")
    model = t_build(cfg)
    want = model.init(torch.Generator().manual_seed(0))
    with t_sh.use_sharding(_t_mesh((4, 2), ("data", "model")),
                           overrides=cfg.rule_overrides):
        got = init_params(model, torch.Generator().manual_seed(0), "cpu")
    for (path, g), (_, w) in zip(L.tree_leaves(got), L.tree_leaves(want)):
        assert g.shape == w.shape, path
        local = g.to_local()
        idx = tuple(slice(0, n) for n in local.shape)
        np.testing.assert_array_equal(local.numpy(), w[idx].numpy(),
                                      err_msg=str(path))
