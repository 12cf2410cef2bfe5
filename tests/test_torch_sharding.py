"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's, spec for spec.

Every leaf of all ten configs' parameter templates (train and serve rules)
and of their decode caches (serve rules) gets the same partition on the
reference's 16 x 16 and 2 x 16 x 16 mesh stubs (``tests/test_sharding.py``),
as do odd shapes where divisibility falls through to replication and the
batch specs. ``placements`` turns the specs into DTensor placements, on the
stubs and on a world-of-one gloo ``DeviceMesh``, and
``make_train_state_specs`` gives the reference's abstract train state.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.config.parallel import ParallelPlan as JaxPlan  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training.train_step import abstract_train_state as jax_abstract_train_state  # noqa: E402
from repro_torch.config.parallel import ParallelPlan  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_devices  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.training.checkpoint import flatten_with_names  # noqa: E402
from repro_torch.training.train_step import make_train_state_specs  # noqa: E402


def mesh_stub(**axes):
    """tests/test_sharding.py's duck-typed mesh."""
    return SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


MESHES = {"single": mesh_stub(data=16, model=16), "multi": mesh_stub(pod=2, data=16, model=16)}
KINDS = ("train", "serve")


def _rules(mesh, kind, zero3=True):
    plan = dict(zero3=zero3)
    return (rules.default_rules(ParallelPlan(**plan).restrict_to(mesh.axis_names), kind),
            jax_rules.default_rules(JaxPlan(**plan).restrict_to(mesh.axis_names), kind))


def _specs_equal(template, ours, theirs, mesh):
    n = 0
    for path, s in tree_items(template):
        got = rules.spec_for_axes(s.shape, s.axes, ours, mesh)
        want = tuple(jax_rules.spec_for_axes(s.shape, s.axes, theirs, mesh))
        assert got == want, (path, s.shape, s.axes, got, want)
        n += 1
    return n


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_default_rules_match_reference(mesh, kind, zero3):
    ours, theirs = _rules(MESHES[mesh], kind, zero3)
    assert ours == {k: tuple(tuple(c) for c in v) for k, v in theirs.items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, kind):
    """Every parameter leaf of the full config, as the reference places it."""
    m = MESHES[mesh]
    ours, theirs = _rules(m, kind)
    template = build(get_config(arch), device="meta").param_template
    jax_template = jax_build(jax_get_config(arch)).param_template
    assert {p: (s.shape, s.axes) for p, s in tree_items(template)} == \
           {p: (tuple(s.shape), tuple(s.axes)) for p, s in tree_items(jax_template)}
    assert _specs_equal(template, ours, theirs, m) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    """Every decode-cache leaf at a serving batch (divisible and not) and cache length."""
    m = MESHES[mesh]
    ours, theirs = _rules(m, "serve")
    api = build(get_config(arch), device="meta")
    for batch, cache_len in ((128, 32768), (8, 4096), (3, 448)):
        spec = api.cache_spec(batch, cache_len)
        jax_spec = jax_build(jax_get_config(arch)).cache_spec(batch, cache_len)
        assert {p: (s.shape, s.axes) for p, s in tree_items(spec)} == \
               {p: (tuple(s.shape), tuple(s.axes)) for p, s in tree_items(jax_spec)}
        _specs_equal(spec, ours, theirs, m)


ODD = [((1600, 25), ("embed", "heads")), ((25, 1600), ("heads", "embed")),
       ((7, 9, 11), ("vocab", "embed", "ffn")), ((128, 4096, 1536), ("experts", "embed", "ffn")),
       ((95, 128, 32768, 8, 128), ("layers", "batch", "cache_seq", "kv_heads", None)),
       ((95, 3, 1000, 5, 64), ("layers", "batch", "cache_seq", "kv_heads", None)),
       ((48, 1024), ("ffn", "ssm_state")), ((1, 1), ("batch", "window")),
       ((17,), ("not-a-rule",)), ((2, 32), ("ssm_in", "ffn"))]


@pytest.mark.parametrize("zero3", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,axes", ODD)
def test_odd_shapes_fall_through_as_in_the_reference(shape, axes, kind, zero3):
    for m in MESHES.values():
        ours, theirs = _rules(m, kind, zero3)
        assert rules.spec_for_axes(shape, axes, ours, m) == \
               tuple(jax_rules.spec_for_axes(shape, axes, theirs, m))
    if shape == (1600, 25):   # 25 heads cannot split 16 ways: replicated
        assert rules.spec_for_axes(shape, axes, _rules(MESHES["single"], kind)[0],
                                   MESHES["single"])[1:] == ()


@pytest.mark.parametrize("batch", [256, 48, 32, 6, 2, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh, batch):
    m = MESHES[mesh]
    got = rules.batch_spec(ParallelPlan().restrict_to(m.axis_names), m, batch)
    assert got == tuple(jax_rules.batch_spec(JaxPlan().restrict_to(m.axis_names), m, batch))


def test_placements_on_the_stub():
    m = MESHES["multi"]
    assert rules.placements((("pod", "data"), "model"), 2, m) == (Shard(0), Shard(0), Shard(1))
    assert rules.placements((None, None, "data"), 3, m) == (Replicate(), Shard(2), Replicate())
    assert rules.placements((), 0, m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="more entries"):
        rules.placements(("data", None, "model"), 2, m)
    plan = ParallelPlan().restrict_to(m.axis_names)
    batch = {"tokens": torch.empty(64, 128, device="meta"), "frames": torch.empty(2, 5, 3, device="meta")}
    placed = rules.tree_batch_shardings(batch, plan, m)
    assert placed["tokens"].spec == (("pod", "data"),)
    assert placed["tokens"].placements == (Shard(0), Shard(0), Replicate())
    assert placed["frames"].placements == (Shard(0), Replicate(), Replicate())


def test_a_larger_mesh_needs_a_process_group():
    """Runs before the module's world of one is started: no group is up."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        make_mesh((2, 1), ("data", "model"), device_type="cpu")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world_of_one():
    """A (1, 1) gloo mesh of ("data", "model"); the process group is torn down after
    the module."""
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def test_placements_on_a_world_of_one(world_of_one):
    mesh = world_of_one
    assert mesh_devices(mesh) == 1 and rules.mesh_axes(mesh) == {"data": 1, "model": 1}
    plan = ParallelPlan().restrict_to(mesh.mesh_dim_names)
    api = build(get_smoke("olmoe-1b-7b"), device="cpu")
    for tree in (rules.param_shardings(api.param_template, mesh, plan, "train"),
                 rules.param_shardings(api.param_template, mesh, plan, "serve"),
                 rules.cache_shardings(api.cache_spec(2, 16), mesh, plan)):
        for path, s in tree_items(tree):
            assert s.mesh is mesh and s.spec == () and s.placements == (Replicate(), Replicate()), path
    assert rules.replicated(mesh).placements == (Replicate(), Replicate())
    # a batch takes the data axis even at size 1, as the reference's batch_spec does
    assert rules.batch_sharding(plan, mesh, 8).placements == (Shard(0), Replicate())


@pytest.mark.parametrize("compress_grads", [False, True])
@pytest.mark.parametrize("arch", ["granite-8b", "whisper-base", "olmoe-1b-7b"])
def test_train_state_specs_match_reference(arch, compress_grads):
    """The abstract state (names, shapes, dtypes) equals the reference's
    ``abstract_train_state``; the placements' specs are the reference's rules'
    for every parameter, its moments and residual, and ``step`` is replicated."""
    m = MESHES["single"]
    api = build(get_smoke(arch), device="cpu")
    plan = ParallelPlan(compress_grads=compress_grads).restrict_to(m.axis_names)
    abstract, placed = make_train_state_specs(api, plan, m)
    japi = jax_build(jax_get_smoke(arch))
    jabstract = jax_abstract_train_state(japi, JaxPlan(compress_grads=compress_grads)
                                         .restrict_to(m.axis_names))
    got = [(n, tuple(t.shape), str(t.dtype).removeprefix("torch."), t.device.type)
           for n, t in flatten_with_names(abstract)]
    want = [(n, tuple(s.shape), np.dtype(s.dtype).name, "meta")
            for n, s in jax_ckpt._flatten_with_names(jabstract)]
    assert got == want
    specs = dict(flatten_with_names(placed))
    assert sorted(specs) == sorted(n for n, *_ in got)
    theirs = jax_rules.default_rules(JaxPlan(compress_grads=compress_grads)
                                     .restrict_to(m.axis_names), "train")
    for path, s in tree_items(japi.param_template):
        want_spec = tuple(jax_rules.spec_for_axes(s.shape, s.axes, theirs, m))
        for prefix in ("params", "opt/mu", "opt/nu") + (("residual/residual",) if compress_grads else ()):
            assert specs[f"{prefix}/{path}"].spec == want_spec, (prefix, path)
    assert specs["opt/step"].spec == () and specs["opt/step"].placements == (Replicate(),) * 2
