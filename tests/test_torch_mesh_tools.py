"""The port's mesh and sharding tools, elastic resizing and gradient
compression against the reference, on the CPU.

* `schema.logical_to_spec` / `schema.shardings` and `dist.sharding`'s
  param (train and decode rules), optimizer and batch specs equal the
  reference's `NamedSharding.spec` for all ten registry configs on meshes
  of shape {data 16, model 16}, {pod 2, data 16, model 16} and {data 2,
  model 4}; the reference runs on `jax.sharding.AbstractMesh`, which needs
  no devices.
* `launch.mesh`: the planning shapes, the census, `make_local_mesh` and
  `make_worlds_mesh` raising with the actual counts (with the census
  patched to N CPU devices, as the reference's tests force N host devices).
* The worlds mesh's placement: lanes padded modulo B, split and gathered
  back.
* `dist.elastic`: the counterpart of `tests/dist/test_elastic_checkpoint.py::
  TestResizePlan` (the exhaustive sweep, the hypothesis property, shrink and
  grow), every plan equal to the reference's.
* `dist.compression`: q, scale, the new error and the decompressed tensors
  bit for bit the reference's on float32 and bf16 gradients over several
  error-feedback steps, and the compression ratio.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro.configs import registry as r_registry
from repro.dist import compression as r_comp
from repro.dist import elastic as r_elastic
from repro.dist import sharding as r_sharding
from repro.launch import mesh as r_mesh
from repro.models import schema as r_schema
from repro.models import stack as r_stack
from repro_torch.configs import registry as t_registry
from repro_torch.core.engine.state import tree_leaves
from repro_torch.dist import compression, elastic, sharding
from repro_torch.launch import mesh
from repro_torch.models import schema, stack
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = sorted(r_registry.names())
MESHES = {
    "data16-model16": (("data", "model"), (16, 16)),
    "pod2-data16-model16": (("pod", "data", "model"), (2, 16, 16)),
    "data2-model4": (("data", "model"), (2, 4)),
}
CPU = torch.device("cpu")


def _meshes(name):
    names, sizes = MESHES[name]
    return AbstractMesh(sizes, names), mesh.Mesh(names, sizes)


def _specs(named: dict) -> dict:
    return {n: tuple(s.spec) for n, s in named.items()}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name):
    r_m, t_m = _meshes(mesh_name)
    r_cfg, t_cfg = r_registry.get(arch), t_registry.get(arch)
    assert mesh.data_axes(t_m) == r_mesh.data_axes(r_m)
    assert mesh.data_size(t_m) == r_mesh.data_size(r_m)
    for mode in ("train", "decode"):
        rules = sharding.rules_for(t_m, mode)
        assert rules == r_sharding.rules_for(r_m, mode), mode
        want = _specs(r_sharding.param_shardings(r_cfg, r_m, mode))
        got = sharding.param_shardings(t_cfg, t_m, mode)
        assert got == want, mode
        # the schema's two steps, as the reference takes them
        sch = stack.build_schema(t_cfg)
        r_sch = r_stack.build_schema(r_cfg)
        for n, s in sch.items():
            assert schema.logical_to_spec(s.axes, rules) == tuple(
                r_schema.logical_to_spec(r_sch[n].axes, rules)), (mode, n)
        assert schema.shardings(sch, rules, t_m) == _specs(r_schema.shardings(r_sch, rules, r_m))
        opt = sharding.opt_shardings(got, t_m)
        r_opt = r_sharding.opt_shardings(r_sharding.param_shardings(r_cfg, r_m, mode), r_m)
        assert opt["m"] == opt["v"] == got and opt["step"] == tuple(r_opt["step"].spec) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    """Leading dims that the data axes divide shard, others (and scalars)
    replicate; nested dicts follow."""
    r_m, t_m = _meshes(mesh_name)
    shapes = {"tokens": (64, 128), "labels": (64, 128), "odd": (3, 5), "scalar": (),
              "frames": (32, 80, 16), "inner": {"patches": (2, 7, 7)}}

    def tree(fn, x):
        return {k: tree(fn, v) for k, v in x.items()} if isinstance(x, dict) else fn(x)

    r_spec = tree(lambda s: jax.ShapeDtypeStruct(s, jnp.int32), shapes)
    t_spec = tree(lambda s: torch.empty(s, dtype=torch.int32, device="meta"), shapes)
    want = tree(lambda s: tuple(s.spec), r_sharding.batch_shardings(r_m, r_spec))
    assert sharding.batch_shardings(t_m, t_spec) == want


def test_worlds_spec_and_logical_rules_edge_cases():
    assert sharding.worlds_pspec() == tuple(r_sharding.worlds_pspec()) == (mesh.WORLDS_AXIS,)
    assert sharding.worlds_pspec(False) == tuple(r_sharding.worlds_pspec(False)) == ()
    assert mesh.WORLDS_AXIS == r_mesh.WORLDS_AXIS
    rules = {"a": "model", "b": "model", "c": ("pod", "data"), "d": ("pod", "data")}
    for axes in (("a", "b"), ("c", "d", "a"), (None, "a", "zzz"), ()):
        assert schema.logical_to_spec(axes, rules) == tuple(
            r_schema.logical_to_spec(axes, rules)), axes


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_production_mesh_is_a_planning_shape():
    m = mesh.make_production_mesh()
    assert (m.shape, m.size, m.devices) == ({"data": 16, "model": 16}, 256, ())
    m = mesh.make_production_mesh(multi_pod=True)
    assert (m.shape, m.size, m.devices) == ({"pod": 2, "data": 16, "model": 16}, 512, ())
    with pytest.raises(ValueError, match="spans 4 devices, got 3"):
        mesh.Mesh(("data", "model"), (2, 2), (CPU,) * 3)


def test_census_is_one_cpu_and_cuda_needs_a_card(monkeypatch):
    assert mesh.local_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.local_devices()
    m = mesh.make_local_mesh(device="cpu")
    assert (m.shape, m.devices) == ({"data": 1, "model": 1}, (CPU,))
    assert m.shape == dict(r_mesh.make_local_mesh().shape)  # one jax CPU device


@pytest.mark.parametrize("n", [1, 4, 6])
def test_local_mesh_raises_with_actual_counts(n, monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [CPU] * n)
    with pytest.raises(ValueError, match=f"{n}.*{n + 1}"):
        mesh.make_local_mesh(model_axis=n + 1)
    with pytest.raises(ValueError, match="model_axis must be >= 1"):
        mesh.make_local_mesh(model_axis=0)
    if n % 2 == 0:
        assert mesh.make_local_mesh(model_axis=2).shape == {"data": n // 2, "model": 2}
    jn = jax.device_count()  # the reference's message on its own count
    with pytest.raises(ValueError, match=f"{jn}.*{jn + 1}"):
        r_mesh.make_local_mesh(model_axis=jn + 1)


@pytest.mark.parametrize("n", [1, 4])
def test_worlds_mesh_bounds(n, monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [CPU] * n)
    m = mesh.make_worlds_mesh()
    assert m.axis_names == (mesh.WORLDS_AXIS,) and m.shape == {mesh.WORLDS_AXIS: n}
    assert len(m.devices) == n
    assert mesh.make_worlds_mesh(1).size == 1
    with pytest.raises(ValueError, match="asked for 0 devices"):
        mesh.make_worlds_mesh(0)
    with pytest.raises(ValueError, match=f"asked for {n + 1} devices, host has {n}"):
        mesh.make_worlds_mesh(n + 1)


# ---------------------------------------------------------------------------
# the worlds mesh's placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,ndev", [(5, 4), (8, 4), (12, 5), (3, 8), (1, 1)])
def test_world_lanes_pad_modulo_b_and_gather_back(B, ndev):
    from repro_torch.core import workloads

    m = mesh.Mesh((mesh.WORLDS_AXIS,), (ndev,), (CPU,) * ndev)
    lanes = sharding.world_lanes(B, m)
    per = math.ceil(B / ndev)
    assert [x.tolist() for x in lanes] == [
        [i % B for i in range(d * per, (d + 1) * per)] for d in range(ndev)]
    bank = workloads.make_ycsb_bank(workloads.YCSBConfig(num_ds=2, records_per_node=64,
                                                         ops_per_txn=2), 2, 4)
    stacked = workloads.stack_banks([bank] * B)
    stacked = stacked._replace(key=stacked.key + torch.arange(B).view(B, 1, 1, 1))
    parts = sharding.place_worlds(stacked, m)
    assert [int(p.key.shape[0]) for p in parts] == [per] * ndev
    assert all(p.num_ds == bank.num_ds for p in parts)
    back = sharding.gather_worlds(parts, B, CPU)
    for (name, x), (_, y) in zip(tree_leaves(back), tree_leaves(stacked)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, name
    shared = sharding.place_worlds(bank, m, batched=False)
    assert len(shared) == ndev and all(torch.equal(s.key, bank.key) for s in shared)


# ---------------------------------------------------------------------------
# elastic resizing (tests/dist/test_elastic_checkpoint.py::TestResizePlan)
# ---------------------------------------------------------------------------


class TestResizePlan:
    def test_exhaustive_small_sweep(self):
        for old in range(1, 9):
            for new in range(1, 9):
                plan = elastic.plan_resize(old, new)
                assert tuple(plan) == tuple(r_elastic.plan_resize(old, new))
                assert plan.new_hosts == new and plan.old_hosts == old
                assert len(plan.sources) == len(plan.batch_ranges) == new
                for srcs in plan.sources:
                    assert all(0 <= s < old for s in srcs)
                for batch in (1, 7, 64, 1000):
                    assert elastic.validate(plan, batch), (old, new, batch)
                    for h in range(new):
                        assert elastic.local_batch(batch, plan, h) == r_elastic.local_batch(
                            batch, r_elastic.plan_resize(old, new), h)

    @given(
        old=st.integers(min_value=1, max_value=64),
        new=st.integers(min_value=1, max_value=64),
        batch=st.integers(min_value=1, max_value=100_000),
    )
    @settings(max_examples=200, deadline=None)
    def test_plan_property(self, old, new, batch):
        plan = elastic.plan_resize(old, new)
        assert elastic.validate(plan, batch)
        rows = [elastic.local_batch(batch, plan, h) for h in range(new)]
        assert sum(hi - lo for lo, hi in rows) == batch
        assert all(hi >= lo for lo, hi in rows)

    def test_shrink_and_grow_reuse_old_shards(self):
        assert elastic.plan_resize(4, 2).sources == ((0,), (1,))
        assert elastic.plan_resize(2, 4).sources == ((0,), (1,), (0,), (1,))
        with pytest.raises(ValueError, match="host counts must be >= 1"):
            elastic.plan_resize(0, 2)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def _same_bits(a, b) -> bool:
    a = np.asarray(a).reshape(-1)
    b = b.detach().numpy().reshape(-1) if b.dtype != torch.bfloat16 else \
        b.view(torch.int16).numpy().reshape(-1).view(a.dtype)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_is_the_reference_bit_for_bit(dtype):
    """Three error-feedback steps over gradients of widely different scales
    (and an all-zero tensor, which takes the 1e-12 scale floor): q, scale,
    the new error and the decompressed gradients bit for bit."""
    rng = np.random.default_rng(0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for trial in range(6):
        g = {"w": (rng.standard_normal((64, 33)) * 10.0 ** rng.uniform(-6, 3)).astype(np.float32),
             "inner": {"b": rng.standard_normal((7,)).astype(np.float32)},
             "zero": np.zeros((5,), np.float32)}
        r_g = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        t_g = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), g)
        r_err, t_err = r_comp.init_error(r_g), compression.init_error(t_g)
        for step in range(3):
            r_c, r_err = r_comp.compress(r_g, r_err)
            t_c, t_err = compression.compress(t_g, t_err)
            for what, r_tree, t_tree in (("q", r_c.q, t_c.q), ("scale", r_c.scale, t_c.scale),
                                         ("error", r_err, t_err),
                                         ("decompressed", r_comp.decompress(r_c),
                                          compression.decompress(t_c))):
                for a, b in zip(jax.tree.leaves(r_tree), jax.tree.leaves(t_tree)):
                    assert _same_bits(a, b), (trial, step, what)
        assert t_c.q["w"].dtype == torch.int8 and t_c.scale["zero"] == np.float32(1e-12)
    assert compression.compression_ratio(t_g) == r_comp.compression_ratio(r_g)
