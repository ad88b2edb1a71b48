"""Port parity for the sharding layer (``repro_torch.parallel.sharding``)
and the pieces of the dry-run that need no step: rule tables, specs,
logical axes of every arch's parameters and the decode-state specs
leaf by leaf against ``repro``'s, ``allocation_mesh_shape``,
``concrete_batch``, DTensor placements of a spec, ``constrain`` on plain
tensors, ``remat="full"``, and the collective table.

Meshes are ``DeviceMesh``es over a fake process group of 8 ranks (this
process is rank 0), started and destroyed by a fixture; ``repro``'s
specs are taken on a ``jax.sharding.AbstractMesh`` of the same shape.
Mirrors tests/test_launch.py:22-80.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke_variant
from repro.configs import shapes as jshapes
from repro.launch import mesh as jmesh
from repro.models import model as jlm
from repro.parallel import sharding as js
from repro.serve import engine as jengine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tlm
from repro_torch.parallel import sharding as ts
from repro_torch.serve import engine as tengine
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(1)


@pytest.fixture
def fake8():
    """A fake process group of 8 ranks, destroyed after the test."""
    dryrun.fake_process_group(8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _abstract_mesh(shape, axes):
    return AbstractMesh(tuple(shape), tuple(axes))


def _paths(tree, path=()):
    """Leaves by path; a tuple (of logical axes, a spec) is a leaf."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _paths(sub, path + (i,)).items()}
    return {path: tree}


def _jpaths(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
            for p, v in flat}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def test_rules_adapt_to_mesh_axes(fake8):
    mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
    rules = ts.rules_for(mesh)
    assert rules["heads"] is None        # no model axis
    assert rules["batch"] == "data"      # no pod axis
    assert ts.spec_for(("batch", "seq"), rules) == ts.P("data", None)
    assert rules == js.rules_for(_abstract_mesh((1,), ("data",)))


@pytest.mark.parametrize("axes,kw", [
    (("data", "model"), {}), (("pod", "data", "model"), {}),
    (("data", "model"), {"shard_cache_seq": True}),
    (("data", "model"), {"fsdp": False}), (("model",), {})])
def test_rules_for_equals_repro(fake8, axes, kw):
    shape = {"pod": 2, "data": 2, "model": 2}
    mesh = tmesh.make_mesh(tuple(shape[a] for a in axes), axes,
                           device="cpu")
    want = js.rules_for(_abstract_mesh([shape[a] for a in axes], axes),
                        **kw)
    assert ts.rules_for(mesh, **kw) == want


def test_safe_spec_divisibility(fake8):
    mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
    rules = {"batch": "data", "heads": "data"}
    # axis size 1 -> dropped (sz>1 required)
    assert ts.safe_spec((7, 3), ("batch", None), mesh, rules) == \
        ts.P(None, None)


def test_safe_spec_equals_repro_on_a_4x2_mesh(fake8):
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    jm = _abstract_mesh((4, 2), ("data", "model"))
    rules = ts.rules_for(mesh)
    rng = np.random.default_rng(0)
    names = ("batch", "heads", "kv_heads", "tp", "fsdp", None, "seq")
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(v) for v in rng.integers(1, 13, size=nd))
        nm = tuple(names[int(i)] for i in rng.integers(len(names), size=nd))
        assert tuple(ts.safe_spec(shape, nm, mesh, rules)) == \
            tuple(js.safe_spec(shape, nm, jm, rules)), (shape, nm)


def test_param_logical_axes_moe_no_duplicate():
    params = {"moe": {"w_gate": torch.zeros((160, 64, 32)),
                      "w_down": torch.zeros((160, 32, 64)),
                      "router": torch.zeros((64, 160))},
              "attn": {"w_q": torch.zeros((64, 64))}}
    axes = ts.param_logical_axes(params, n_expert_hint=160)
    for a in _paths(axes).values():
        resolved = [ts.DEFAULT_RULES.get(n) if n else None for n in a]
        named = [r for r in resolved if isinstance(r, str)]
        assert len(named) == len(set(named)), a


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_equal_repro_for_every_arch(arch):
    jcfg = jsmoke_variant(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jax.eval_shape(lambda: jlm.init_model(jcfg,
                                                    jax.random.PRNGKey(0)))
    params = tlm.init_model(cfg, device="meta")
    want = _jpaths(js.param_logical_axes(jparams, cfg.n_experts),
                   is_leaf=_is_axes)
    got = _paths(ts.param_logical_axes(params, cfg.n_experts))
    assert got == want
    rules = js.rules_for(_abstract_mesh((2, 4, 2), ("pod", "data", "model")))
    jspecs = _jpaths(js.param_specs(jparams, rules, cfg.n_experts),
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    specs = _paths(ts.param_specs(params, rules, cfg.n_experts))
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in jspecs.items()}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b",
                                  "deepseek-v2-236b"])
def test_decode_state_specs_equal_repro_on_a_4x2_mesh(fake8, arch):
    jcfg = jsmoke_variant(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    jm = _abstract_mesh((4, 2), ("data", "model"))
    for kw in ({}, {"shard_cache_seq": True}):
        rules = ts.rules_for(mesh, **kw)
        jstate = jax.eval_shape(lambda: jengine.init_state(jcfg, 8, 64))
        state = tengine.init_state(cfg, 8, 64, device="meta")
        want = _jpaths(js.decode_state_specs(jstate, jm, rules))
        got = _paths(ts.decode_state_specs(state, mesh, rules))
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].spec) == tuple(want[k].spec), k
        batch = tshapes.batch_specs(cfg, tshapes.smoke_shape("decode",
                                                             64, 8))
        jbatch = jshapes.batch_specs(jcfg, jshapes.smoke_shape("decode",
                                                               64, 8))
        assert {k: tuple(v.spec) for k, v in
                ts.batch_specs_sharding(batch, mesh, rules).items()} == \
            {k: tuple(v.spec) for k, v in
             js.batch_specs_sharding(jbatch, jm, rules).items()}


def test_allocation_mesh_shape_equals_repro():
    for n in range(1, 4097):
        assert tmesh.allocation_mesh_shape(n) == \
            jmesh.allocation_mesh_shape(n), n
    for n, m in [(24, 6), (16, 4), (36, 5), (7, 3), (64, 16), (100, 8)]:
        assert tmesh.allocation_mesh_shape(n, prefer_model=m) == \
            jmesh.allocation_mesh_shape(n, prefer_model=m)


@pytest.mark.parametrize("arch,kind", [
    ("llama3-8b", "train"), ("qwen2-vl-7b", "train"),
    ("musicgen-medium", "prefill"), ("qwen2-vl-7b", "decode"),
    ("zamba2-1.2b", "decode")])
def test_concrete_batch_equals_repro(arch, kind):
    jcfg = jsmoke_variant(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    shape = tshapes.smoke_shape(kind, 16, 3)
    got = tshapes.concrete_batch(cfg, shape, seed=5, device="cpu")
    want = jshapes.concrete_batch(jcfg, jshapes.smoke_shape(kind, 16, 3),
                                  seed=5)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    specs = tshapes.batch_specs(cfg, shape)
    assert all(v.is_meta and tuple(v.shape) == tuple(got[k].shape)
               for k, v in specs.items())


def test_concrete_batch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = smoke_variant(get_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshapes.concrete_batch(cfg, tshapes.smoke_shape())


def test_constrain_is_a_no_op_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert ts.constrain(x, "batch", "seq", "embed") is x
    with ts.logical_rules(dict(ts.DEFAULT_RULES)):
        assert ts.current_rules() is not None
        assert ts.constrain(x, "batch", "seq", "embed") is x
        assert ts.replicated(x) is x
    assert ts.current_rules() is None


def test_spec_placements(fake8):
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="cpu")
    # two axes on one dim: Shard(d) on both mesh dims, in mesh order
    assert ts.spec_placements(ts.P(("pod", "data"), None, "model"),
                              mesh) == [Shard(0), Shard(0), Shard(2)]
    assert ts.NamedSharding(mesh, ts.P(None, "data")).placements == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        ts.spec_placements(ts.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="two dims"):
        ts.spec_placements(ts.P("data", "data"), mesh)
    with pytest.raises(ValueError, match="no 'tp'"):
        ts.spec_placements(ts.P("tp"), mesh)


def test_shard_map_and_constrain_run_plain_without_rules():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    a, b = torch.ones(2, 3), torch.ones(2, 3)
    out = ts.shard_map(fn, (("batch", None), ("batch", None)),
                       ("batch", None))(a, b)
    assert calls == [1] and torch.equal(out, a + b)


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_remat_full_grads_equal_none_and_count_more_flops(arch):
    cfg = smoke_variant(get_config(arch))
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = tshapes.concrete_batch(cfg, tshapes.smoke_shape("train", 16, 2),
                                   seed=0, device="cpu")
    (loss0, _), g0 = value_and_grad(cfg, params, batch)
    (loss1, _), g1 = value_and_grad(cfg.replace(remat="full"), params, batch)
    assert torch.equal(loss0, loss1)
    for a, b in zip(tlm.tree_leaves(g0), tlm.tree_leaves(g1)):
        assert torch.equal(a, b)
    shape = tshapes.smoke_shape("train", 32, 2)
    none = dryrun.one_rank_cost(cfg, shape, device="cpu")
    full = dryrun.one_rank_cost(cfg.replace(remat="full"), shape,
                                device="cpu")
    assert full["flops"] > none["flops"] > 0
    # no grad, no recompute
    pre = tshapes.smoke_shape("prefill", 32, 2)
    assert dryrun.one_rank_cost(cfg.replace(remat="full"), pre,
                                device="cpu")["flops"] == \
        dryrun.one_rank_cost(cfg, pre, device="cpu")["flops"]


def test_collective_bytes_totals():
    table = {op: {"bytes": 0, "count": 0} for op in dryrun.COLLECTIVE_OPS}
    table["all-reduce"] = {"bytes": 128 * 256 * 4, "count": 1}
    table["all-gather"] = {"bytes": 64 * 2, "count": 1}
    table["collective-permute"] = {"bytes": 32, "count": 1}
    out = dryrun.collective_bytes(table)
    assert out["all-reduce"]["bytes"] == 128 * 256 * 4
    assert out["total_bytes"] == 128 * 256 * 4 + 64 * 2 + 32
    assert out["total_count"] == 3
    assert set(dryrun.COLLECTIVE_OPS) <= set(out)
