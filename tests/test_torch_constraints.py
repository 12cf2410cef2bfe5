"""The port's activation constraints, the kernels' DTensor route, the
production mesh, the serve shardings and the reference's public names that
the port gained with the sharded steps, against the reference.

``shard_act`` is the identity outside ``activation_constraints`` and on a
plain tensor; inside it, its spec for each kind is the one the reference's
``shard_act`` builds from ``_axes_for`` on the reference's mesh stubs. On a
world-of-one gloo mesh each of the five kernels' ``ops`` entries gives a
DTensor the plain tensor's output. ``make_production_mesh`` has the
reference's axis names and shape (the reference's mesh is built in a
subprocess with 512 forced host devices) and refuses a group of another
backend. ``serve_shardings`` places parameters, cache and tokens by the
reference's rules, and ``all_configs``, ``ModelApi.logical_axes`` /
``cache_logical_axes``, ``common.logical_axes`` / ``tree_map_specs`` /
``is_spec`` and ``abstract_adamw_state`` equal the reference's.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor  # noqa: E402

from repro.config.parallel import ParallelPlan as JaxPlan  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import all_configs as jax_all_configs  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.sharding import constraints as jax_constraints  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro.training.optimizer import abstract_adamw_state as jax_abstract_adamw_state  # noqa: E402
from repro_torch.config.parallel import ParallelPlan  # noqa: E402
from repro_torch.configs import all_configs, get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.engine import serve_shardings  # noqa: E402
from repro_torch.sharding import constraints  # noqa: E402
from repro_torch.sharding.rules import placements  # noqa: E402
from repro_torch.training.optimizer import abstract_adamw_state  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def mesh_stub(**axes):
    """tests/test_sharding.py's duck-typed mesh."""
    return SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


STUBS = {"single": mesh_stub(data=16, model=16), "multi": mesh_stub(pod=2, data=16, model=16),
         "odd": mesh_stub(data=3, model=5)}
SHAPES = {"bsd": [(32, 7, 64), (3, 7, 64)], "bd": [(32, 64), (5, 64)],
          "bshd": [(32, 7, 16, 8), (6, 7, 10, 8)], "bsf": [(32, 7, 48), (1, 7, 5)],
          "bsv": [(32, 7, 4096), (2, 7, 15)], "bhd": [(32, 16, 8), (9, 4, 8)],
          "bshp": [(32, 7, 3, 64), (4, 7, 24, 10)]}


def _reference_spec(ctx, shape, kind):
    """The spec the reference's ``shard_act`` constrains to, from its ``_axes_for``."""
    ax = lambda names, dim: jax_constraints._axes_for(ctx, names, dim)
    d, m = ctx["data"], ctx["model"]
    return {"bsd": lambda: (ax(d, shape[0]),), "bd": lambda: (ax(d, shape[0]),),
            "bshd": lambda: (ax(d, shape[0]), None, ax(m, shape[2]), None),
            "bsf": lambda: (ax(d, shape[0]), None, ax(m, shape[2])),
            "bsv": lambda: (ax(d, shape[0]), None, ax(m, shape[2])),
            "bhd": lambda: (ax(d, shape[0]), ax(m, shape[1])),
            "bshp": lambda: (ax(d, shape[0]), None, None, ax(m, shape[3]))}[kind]()


# ---------------------------------------------------------------- shard_act
@pytest.mark.parametrize("stub", list(STUBS))
@pytest.mark.parametrize("kind", list(SHAPES))
def test_act_spec_matches_the_reference(kind, stub):
    mesh = STUBS[stub]
    plan = ParallelPlan().restrict_to(mesh.axis_names)
    ctx = {"mesh": mesh, "data": tuple(plan.data_axes), "model": tuple(plan.tensor_axes)}
    assert constraints.act_spec(SHAPES[kind][0], kind) is None   # outside the context
    with constraints.activation_constraints(mesh, plan):
        for shape in SHAPES[kind]:
            got = constraints.act_spec(shape, kind)
            want = _reference_spec(ctx, shape, kind)
            assert got == want, (shape, got, want)
            assert tuple(jax_constraints.P(*want)) == want
            assert placements(got, len(shape), mesh) == placements(want, len(shape), mesh)
        for names in (("data",), ("pod", "data"), ("model",), ("nope",)):
            for dim in (1, 5, 16, 32, 64):
                assert constraints._axes_for(ctx, names, dim) == \
                    jax_constraints._axes_for(ctx, names, dim)
        assert constraints.act_spec(SHAPES[kind][0], "other") is None


# ---------------------------------------------------------------- the production mesh
def _reference_meshes():
    code = ("from repro.launch.mesh import make_production_mesh as m\n"
            "a, b = m(), m(multi_pod=True)\n"
            "print(repr((tuple(a.axis_names), tuple(a.devices.shape), tuple(b.axis_names), "
            "tuple(b.devices.shape))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return eval(proc.stdout.strip().splitlines()[-1])


def test_production_mesh_matches_the_reference():
    """Both meshes on one fake group of 512 ranks, torn down after."""
    assert not dist.is_initialized()
    try:
        multi = make_production_mesh(multi_pod=True)
        single = make_production_mesh()
        assert dist.get_backend() == "fake" and dist.get_world_size() == 512
        got = (single.mesh_dim_names, tuple(single.shape), multi.mesh_dim_names,
               tuple(multi.shape))
    finally:
        dist.destroy_process_group()
    assert got == _reference_meshes()
    assert got == (("data", "model"), (16, 16), ("pod", "data", "model"), (2, 16, 16))


def test_production_mesh_refuses_a_group_of_another_backend():
    assert not dist.is_initialized()
    make_mesh((1, 1), ("data", "model"), device_type="cpu")   # a gloo world of one
    try:
        with pytest.raises(RuntimeError, match="'gloo' group is up"):
            make_production_mesh()
        assert dist.is_initialized() and dist.get_backend() == "gloo"   # left as it was
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_of_one():
    """A (1, 1) gloo mesh of ("data", "model"); torn down after the module."""
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def test_shard_act_is_the_identity_outside_the_context_and_on_plain_tensors(world_of_one):
    mesh = world_of_one
    x = torch.randn(4, 3, 8)
    dx = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    for kind in SHAPES:
        assert constraints.shard_act(x, kind) is x
        assert constraints.shard_act(dx, kind) is dx
    with constraints.activation_constraints(mesh, ParallelPlan().restrict_to(("data", "model"))):
        assert constraints.shard_act(x, "bsd") is x
        # a size-1 axis shards nothing: the spec is all None, the placements replicated
        out = constraints.shard_act(dx, "bsd")
        assert isinstance(out, DTensor) and out.placements == (Replicate(), Replicate())
        assert torch.equal(out.full_tensor(), x)


def test_make_mesh_builds_on_the_device_type_it_is_given(world_of_one, monkeypatch):
    """With a group up, ``make_mesh`` hands its ``device_type`` to ``init_device_mesh``
    (a CUDA mesh on the card; no card is needed to see the call)."""
    from repro_torch.launch import mesh as mesh_mod

    seen = []
    monkeypatch.setattr(mesh_mod, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: seen.append((dev, shape, mesh_dim_names)))
    make_mesh((1, 1), ("data", "model"), device_type="cuda")
    make_mesh([1, 1], ["data", "model"], device_type="cpu")
    assert seen == [("cuda", (1, 1), ("data", "model")), ("cpu", (1, 1), ("data", "model"))]


# ---------------------------------------------------------------- the ops DTensor route
def _kernel_inputs():
    gen = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    slot_pos = torch.tensor([[0, 1, 2, 3, 4, -1, -1, -1], [0, 1, 2, 3, 4, 5, 6, 7]],
                            dtype=torch.int32)
    return {
        "rmsnorm": (lambda x, s: ops.rmsnorm(x, s, eps=1e-5), (rnd(2, 5, 16), rnd(16))),
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v, causal=True, window=3),
                            (rnd(2, 8, 4, 16), rnd(2, 8, 2, 16), rnd(2, 8, 2, 16))),
        "decode_attention": (lambda *t: ops.decode_attention(*t, window=4),
                             (rnd(2, 4, 16), rnd(2, 8, 2, 16), rnd(2, 8, 2, 16), slot_pos,
                              torch.tensor([4, 7], dtype=torch.int32))),
        "moe_gmm": (ops.moe_gmm, (rnd(4, 8, 16), rnd(4, 16, 8),
                                  torch.tensor([[4, 0], [2, 3], [0, 0], [1, 4]],
                                               dtype=torch.int32))),
        "ssd": (lambda *t: ops.ssd(*t, chunk=4),
                (rnd(2, 8, 2, 4), -torch.rand(2, 8, 2, generator=gen), rnd(2, 8, 4),
                 rnd(2, 8, 4))),
    }


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "decode_attention", "moe_gmm",
                                    "ssd"])
def test_ops_give_a_dtensor_the_plain_tensors_output(world_of_one, kernel):
    """The DTensor goes to the kernel's plain version on its local shard: the same
    values, as a DTensor on the input's mesh, and no launch on the CPU."""
    mesh = world_of_one
    fn, args = _kernel_inputs()[kernel]
    want = fn(*args)
    ops.reset_launch_counts()
    got = fn(*(distribute_tensor(a, mesh, (Replicate(), Replicate())) for a in args))
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        assert isinstance(g, DTensor) and g.device_mesh is mesh
        assert torch.equal(g.full_tensor(), w)


def test_model_helpers_give_a_dtensor_the_plain_values(world_of_one):
    """``take_rows`` (the embedding lookup), ``take_last`` (the loss's gold logit)
    and ``unshard`` on replicated DTensors; plain tensors go the plain way."""
    mesh = world_of_one
    rep = (Replicate(), Replicate())
    gen = torch.Generator().manual_seed(5)
    table, logits = torch.randn(32, 8, generator=gen), torch.randn(2, 3, 32, generator=gen)
    idx = torch.randint(0, 32, (2, 3), generator=gen)
    dt = lambda t: distribute_tensor(t, mesh, rep)
    assert torch.equal(constraints.take_rows(table, idx), table[idx])
    assert torch.equal(constraints.take_rows(dt(table), dt(idx)).full_tensor(), table[idx])
    gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    assert torch.equal(constraints.take_last(logits, idx), gold)
    assert torch.equal(constraints.take_last(dt(logits), dt(idx)).full_tensor(), gold)
    assert constraints.unshard(logits, -1) is logits
    d = dt(logits)
    assert constraints.unshard(d, -1) is d
    assert constraints.local_span(d, 2) == (0, 32)


def test_shard_plan_keeps_the_roles_and_replicates_the_rest():
    """The rule of the local call, on placements alone (a stub of two mesh dims of 2)."""
    mesh = SimpleNamespace(ndim=2, size=lambda i: 2)
    t = lambda shape, *p: SimpleNamespace(shape=shape, placements=p, device_mesh=mesh)
    attn = {"b": 0, "h": 2}
    # q and k/v sharded on heads over the model axis: the heads stay sharded
    q, k = t((4, 8, 8, 16), Shard(0), Shard(2)), t((4, 8, 2, 16), Shard(0), Shard(2))
    assert ops.shard_plan([q, k, k], [attn] * 3) == ["b", "h"]
    # a sequence-sharded cache: the batch role stays, the sequence is replicated
    q3, kc = t((4, 8, 16), Shard(0), Shard(1)), t((4, 8, 2, 16), Shard(0), Shard(1))
    assert ops.shard_plan([q3, kc], [{"b": 0, "h": 1}, attn]) == ["b", "h"]
    # 3 KV heads do not split over 2: every input's heads are replicated
    k3 = t((4, 8, 3, 16), Shard(0), Replicate())
    assert ops.shard_plan([q, k3], [attn] * 2) == ["b", None]
    # a reduced dim (rmsnorm's D) is never a role
    x = t((4, 16), Replicate(), Shard(1))
    assert ops.shard_plan([x, t((16,), Replicate(), Replicate())], [{"row0": 0}, {}]) == \
        [None, None]
    assert ops.placements_for(["b", None], attn) == (Shard(0), Replicate())


# ---------------------------------------------------------------- serve_shardings
@pytest.mark.parametrize("stub", ["single", "multi"])
@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b", "whisper-base", "hymba-1.5b"])
def test_serve_shardings_match_the_reference_rules(arch, stub):
    mesh = STUBS[stub]
    plan = ParallelPlan().restrict_to(mesh.axis_names)
    jplan = JaxPlan().restrict_to(mesh.axis_names)
    api = build(get_smoke(arch), device="cpu")
    japi = jax_build(jax_get_smoke(arch))
    batch, cache_len = 32, 64
    psh, csh, tsh = serve_shardings(api, plan, mesh, batch, cache_len)
    theirs = jax_rules.default_rules(jplan, "serve")
    for got, template in ((psh, japi.param_template), (csh, japi.cache_spec(batch, cache_len))):
        want, got = dict(tree_items(template)), dict(tree_items(got))
        assert sorted(got) == sorted(want)
        for path, s in want.items():
            spec = tuple(jax_rules.spec_for_axes(s.shape, s.axes, theirs, mesh))
            assert got[path].spec == spec, path
            assert got[path].placements == placements(spec, len(s.shape), mesh)
    assert tsh.spec == tuple(jax_rules.batch_spec(jplan, mesh, batch))


# ---------------------------------------------------------------- the reference's names
def test_all_configs_match_the_reference():
    mine, theirs = all_configs(), jax_all_configs()
    assert list(mine) == list(theirs) == ARCH_IDS
    for arch, cfg in mine.items():
        ref = theirs[arch]
        names = [f.name for f in dataclasses.fields(cfg)]
        assert names == [f.name for f in dataclasses.fields(ref)]
        assert {n: getattr(cfg, n) for n in names} == {n: getattr(ref, n) for n in names}, arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_the_reference(arch):
    api, japi = build(get_smoke(arch), device="cpu"), jax_build(jax_get_smoke(arch))
    assert api.logical_axes() == japi.logical_axes()
    assert api.cache_logical_axes(2, 16) == japi.cache_logical_axes(2, 16)
    assert common.logical_axes(api.param_template) == jax_common.logical_axes(japi.param_template)
    spec = next(s for _, s in tree_items(api.param_template))
    assert common.is_spec(spec) and not common.is_spec(spec.shape) and not common.is_spec({})
    shapes = common.tree_map_specs(lambda s: s.shape, api.param_template)
    assert shapes == jax_common.tree_map_specs(lambda s: s.shape, japi.param_template)


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-base", "olmoe-1b-7b"])
def test_abstract_adamw_state_matches_the_reference(arch):
    api, japi = build(get_smoke(arch), device="cpu"), jax_build(jax_get_smoke(arch))
    mine = abstract_adamw_state(api.abstract_params())
    theirs = jax_abstract_adamw_state(japi.abstract_params())
    assert mine.step.device.type == "meta" and mine.step.dtype == torch.int32
    assert tuple(mine.step.shape) == tuple(theirs.step.shape) == ()
    for field in ("mu", "nu"):
        got = {p: (tuple(t.shape), t.dtype, t.device.type)
               for p, t in tree_items(getattr(mine, field))}
        want = {p: (tuple(s.shape), torch.float32, "meta")
                for p, s in tree_items(getattr(theirs, field)) if np.dtype(s.dtype) == np.float32}
        assert got == want and len(want) == len(list(tree_items(getattr(theirs, field))))
