"""The port's launch CLIs and input specs against the reference's.

``launch.specs`` gives the reference's shapes and dtypes (meta tensors for
``jax.ShapeDtypeStruct``s) for all ten smoke configs in the train, prefill
and decode kinds. ``launch.serve`` on weights carried across by
``repro_torch.bridge`` gives the reference batcher's tokens on the prompts
the reference's CLI draws, and serves whisper-base and internvl2-76b,
which the reference's CLI cannot (pinned here as tests of the reference).
``launch.train`` restores a checkpoint written by the reference's CLI and by
``jax``'s checkpoint writer and trains to the reference CLI's losses within
``_tol``; a crashed and resumed run equals an uninterrupted one bitwise.
Everything runs on the CPU, where the kernels take their plain versions.
"""
import contextlib
import io
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.config.parallel import ParallelPlan as JaxPlan  # noqa: E402
from repro.config.shapes import ShapeConfig as JaxShape  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.batching import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batching import Request as JaxRequest  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training.train_step import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config.shapes import ShapeConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, specs, train  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.training.data import to_device  # noqa: E402

F32_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_kernels.py::_tol, float32


# ---------------------------------------------------------------- specs
def _flat(tree):
    """{path: (shape, dtype name)} of a tree of meta tensors or ShapeDtypeStructs."""
    if isinstance(tree, tuple):
        tree = list(tree)
    out = {}
    for path, x in tree_items(tree):
        dt = str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor) else np.dtype(x.dtype).name
        if isinstance(x, torch.Tensor):
            assert x.device.type == "meta", path
        out[path] = (tuple(x.shape), dt)
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, kind):
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    shape = dict(name="t", seq_len=48, global_batch=3, kind=kind)
    got = specs.input_specs(cfg, ShapeConfig(**shape))
    want = jax_specs.input_specs(jcfg, JaxShape(**shape))
    assert _flat(got) == _flat(want)
    assert list(got) == list(want)
    if kind == "train":
        assert _flat(specs.train_batch_specs(cfg, ShapeConfig(**shape))) == \
               _flat(jax_specs.train_batch_specs(jcfg, JaxShape(**shape)))
    elif kind == "prefill":
        assert _flat(specs.prefill_input_specs(cfg, ShapeConfig(**shape))) == \
               _flat(jax_specs.prefill_input_specs(jcfg, JaxShape(**shape)))
    else:
        assert _flat(specs.decode_input_specs(build(cfg, device="meta"), ShapeConfig(**shape))) == \
               _flat(jax_specs.decode_input_specs(jax_build(jcfg), JaxShape(**shape)))
        assert _flat(build(cfg, device="meta").abstract_params()) == \
               _flat(jax_build(jcfg).abstract_params())


# ---------------------------------------------------------------- serve
def _serve_args(*extra):
    return serve.parser().parse_args(["--smoke", "--device", "cpu", *extra])


def _bridged(arch):
    """float32 smoke weights from the reference's PRNGKey(0), in both packages."""
    jcfg = jax_get_smoke(arch).replace(dtype="float32")
    japi = jax_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return get_smoke(arch).replace(dtype="float32"), params, japi, jparams


def _reference_batcher(japi, jparams, args, cfg, extras):
    """The reference CLI's batcher loop on its host rng's prompts."""
    batcher = JaxBatcher(japi, jparams, num_slots=args.slots, cache_len=args.cache_len,
                         extras_fn=lambda rid: extras)
    for rid, prompt in enumerate(serve.prompts(cfg, args)):
        batcher.submit(JaxRequest(rid, prompt, max_new_tokens=args.max_new))
    return batcher.run_to_completion()


def test_serve_prompts_are_the_reference_clis():
    """launch.serve draws the reference CLI's prompts: its loop, replayed here."""
    args = _serve_args("--seed", "3", "--requests", "5")
    host = np.random.default_rng(3)
    want = []
    for _ in range(5):
        plen = int(host.integers(4, min(24, args.cache_len)))
        want.append(host.integers(0, get_smoke("granite-8b").vocab_size, plen).tolist())
    assert serve.prompts(get_smoke("granite-8b"), args) == want


@pytest.mark.parametrize("arch,extra", [("granite-8b", ()), ("granite-8b", ("--slots", "3")),
                                        ("whisper-base", ("--requests", "6"))])
def test_serve_gives_the_reference_batchers_tokens(arch, extra, monkeypatch):
    """The CLI's defaults (16 requests, 8 slots, cache 64, 12 new tokens) on
    bridged float32 weights (the smoke config read in float32): every request's
    tokens equal the reference batcher's; whisper with zero frames of
    ``encoder_frames``."""
    cfg, params, japi, jparams = _bridged(arch)
    monkeypatch.setattr(serve, "get_smoke", lambda name: get_smoke(name).replace(dtype="float32"))
    args = _serve_args("--arch", arch, *extra)
    ops.reset_launch_counts()
    served = serve.run(args, params=params)
    assert set(ops.launch_counts().values()) == {0}   # the plain versions on the CPU
    jextras = {k: jnp.zeros(v.shape, jnp.float32) for k, v in jax_specs.extras_for(
        jax_get_smoke(arch).replace(dtype="float32"), 1).items()}
    want = _reference_batcher(japi, jparams, args, cfg, jextras)
    assert served.results == want
    assert len(served.results) == args.requests
    assert all(len(t) == args.max_new for t in served.results.values())


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
def test_cli_serves_whisper_and_the_vlm(arch, capsys):
    """Through ``main``, on the smoke config's bf16 random weights: 16 requests of 12
    tokens, in the vocabulary."""
    served = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    cfg = get_smoke(arch)
    assert sorted(served.results) == list(range(16))
    for toks in served.results.values():
        assert len(toks) == 12 and all(0 <= t < cfg.vocab_size for t in toks)
    out = capsys.readouterr().out
    assert re.search(r"served 16 requests, 192 tokens in [\d.]+s \([\d.]+ tok/s\)", out)
    assert serve.request_extras(cfg, "cpu")[
        "frames" if cfg.family == "encdec" else "patches"].shape[1] == \
        (cfg.encoder_frames if cfg.family == "encdec" else cfg.num_patches)


@pytest.mark.parametrize("arch,match", [
    # 16 frames against the cross cache's encoder_frames = 32 (launch/serve.py:44)
    ("whisper-base", r"\(2, 1, 16, 4, 16\).*\(2, 1, 32, 4, 16\)"),
    # text padded to cache_len 64 plus 8 patches (launch/serve.py:46)
    ("internvl2-76b", r"\(2, 1, 72, 2, 16\).*\(2, 1, 64, 2, 16\)"),
])
def test_reference_cli_cannot_serve_whisper_or_the_vlm(arch, match, monkeypatch):
    """ROADMAP C: the reference's launch/serve.py fails in insert_slot on both."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke", "--requests", "1",
                                      "--max-new", "2"])
    with pytest.raises(ValueError, match=match):
        jax_serve.main()


# ---------------------------------------------------------------- train
# --lr 1.0 inside the schedule's 100-step warmup: AdamW steps of 0.01-0.04, so each
# step moves the loss by far more than F32_TOL and a CLI that skipped the update,
# ignored --lr or restored the wrong state would not match.
TRAIN = ["--smoke", "--batch", "2", "--seq", "32", "--log-every", "1", "--ckpt-every", "2",
         "--lr", "1.0"]


def _train_args(ckpt_dir, *extra):
    return train.parser().parse_args([*TRAIN, "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
                                      *extra])


def _f32_smoke(monkeypatch):
    """Both CLIs read the smoke config in float32."""
    monkeypatch.setattr(jax_train, "get_smoke", lambda n: jax_get_smoke(n).replace(dtype="float32"))
    monkeypatch.setattr(train, "get_smoke", lambda n: get_smoke(n).replace(dtype="float32"))


def _checkpoint_leaves(ckpt):
    """{leaf name: array} of a checkpoint directory (either package's format)."""
    with open(ckpt / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(ckpt / "shard_00000.npz") as data:
        return {name: data[meta["key"]] for name, meta in manifest["leaves"].items()}


def _assert_checkpoints_close(got, want):
    got, want = _checkpoint_leaves(got), _checkpoint_leaves(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        np.testing.assert_allclose(got[name], w, err_msg=name, **F32_TOL)


@pytest.fixture(scope="module")
def reference_cli_run(tmp_path_factory):
    """The reference's launch/train.py for 4 steps of granite-8b smoke in float32,
    with checkpoints at steps 2 and 4: its checkpoint directory and the printed loss
    and grad_norm of each step."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _f32_smoke(mp)
        mp.setattr(sys, "argv", ["train", *TRAIN, "--steps", "4", "--ckpt-dir", str(ckpt)])
        with contextlib.redirect_stdout(buf):
            jax_train.main()
    printed = re.findall(r"step\s+(\d+) loss\s+([\d.]+) grad_norm\s+([\d.]+)", buf.getvalue())
    losses = {int(k): float(v) for k, v, _ in printed}
    grad_norms = {int(k): float(g) for k, _, g in printed}
    assert sorted(losses) == [1, 2, 3, 4]
    assert abs(losses[4] - losses[1]) > 100 * F32_TOL["atol"]   # the updates move the loss
    return ckpt, losses, grad_norms


def _assert_printed_close(got, want, steps):
    """The port's losses and grad norms against the reference CLI's printed ones
    (4 and 3 decimals)."""
    for key, printed, tol in (("loss", want[1], 5e-5), ("grad_norm", want[2], 5e-4)):
        ours = got.losses if key == "loss" else got.grad_norms
        np.testing.assert_allclose([ours[k] for k in steps], [printed[k] for k in steps],
                                   rtol=F32_TOL["rtol"], atol=F32_TOL["atol"] + tol,
                                   err_msg=key)


def test_train_from_a_bridged_state_matches_the_reference_cli(reference_cli_run, tmp_path, capsys,
                                                              monkeypatch):
    """The reference's float32 initial state (PRNGKey(0)), written by its checkpoint
    writer as step 0, restores in the port's CLI; the 4 steps' losses and grad norms
    are the reference CLI's within ``_tol``, and so is every leaf of the step-4
    checkpoint."""
    src = reference_cli_run[0]
    _f32_smoke(monkeypatch)
    jcfg = jax_get_smoke("granite-8b").replace(dtype="float32")
    state = jax_init_train_state(jax_build(jcfg), jax.random.PRNGKey(0),
                                 JaxPlan(remat="none", zero3=False).restrict_to(("data", "model")))
    jax_ckpt.save_checkpoint(str(tmp_path), 0, state)
    got = train.run(_train_args(tmp_path, "--steps", "4"))
    assert "restored checkpoint at step 0" in capsys.readouterr().out
    assert sorted(got.losses) == sorted(got.grad_norms) == sorted(got.step_s) == [1, 2, 3, 4]
    _assert_printed_close(got, reference_cli_run, [1, 2, 3, 4])
    _assert_checkpoints_close(tmp_path / "step_00000004", src / "step_00000004")
    assert not dist.is_initialized()


def test_reference_cli_checkpoint_resumes_in_the_port(reference_cli_run, tmp_path, capsys,
                                                      monkeypatch):
    """The reference CLI's step-2 checkpoint restores in the port's CLI, which then
    trains steps 3-4 to the reference CLI's losses and grad norms within ``_tol``,
    and writes a step-4 checkpoint equal to the reference's within ``_tol``."""
    src = reference_cli_run[0]
    _f32_smoke(monkeypatch)
    shutil.copytree(src / "step_00000002", tmp_path / "step_00000002")
    got = train.run(_train_args(tmp_path, "--steps", "4"))
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert sorted(got.losses) == [3, 4]
    _assert_printed_close(got, reference_cli_run, [3, 4])
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]
    _assert_checkpoints_close(tmp_path / "step_00000004", src / "step_00000004")


def test_train_crash_and_resume_equals_an_uninterrupted_run(tmp_path):
    """Steps 1-2 then a restart to step 4 give the losses of a straight 4-step run,
    bitwise (the schedule is in its warmup, so --steps does not move it)."""
    straight = train.run(_train_args(tmp_path / "straight", "--steps", "4", "--remat", "full"))
    first = train.run(_train_args(tmp_path / "crash", "--steps", "2", "--remat", "full"))
    second = train.run(_train_args(tmp_path / "crash", "--steps", "4", "--remat", "full"))
    assert sorted(first.losses) == [1, 2] and sorted(second.losses) == [3, 4]
    assert {**first.losses, **second.losses} == straight.losses
    assert {**first.grad_norms, **second.grad_norms} == straight.grad_norms


def test_default_loss_chunk_trains_a_seq_the_reference_refuses():
    """The reference's train_loss picks a loss chunk of 128 for an odd vocabulary and
    then refuses any S it does not divide (whisper-base's 448; ROADMAP C). The port
    takes the largest chunk dividing both, and its loss equals the reference's at
    that chunk; where the reference's chunk divides S, both keep it."""
    from repro.models import encdec as jax_encdec
    from repro_torch.models.layers import default_loss_chunk

    assert default_loss_chunk(51865, 448) == 64
    for vocab, seq in ((51865, 4096), (51865, 100), (49152, 4096), (49152, 448), (32001, 1500),
                       (51865, 255), (51865, 8)):
        rule = min(128 if vocab % 16 else 512, seq)
        want = rule if seq % rule == 0 else np.gcd(seq, rule)
        if want < min(16, seq):   # an odd S would run S one-position chunks: refused
            with pytest.raises(ValueError, match=f"seq {seq} leaves a loss chunk of {want} "):
                default_loss_chunk(vocab, seq)
        else:
            assert default_loss_chunk(vocab, seq) == want
    jcfg = jax_get_smoke("whisper-base").replace(vocab_size=257, dtype="float32")
    japi = jax_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    shape = dict(name="t", seq_len=192, global_batch=2, kind="train")
    batch = jax_data.make_batch(jcfg, JaxShape(**shape), 0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    loss = lambda chunk: jax.jit(lambda p, b: jax_encdec.train_loss(p, b, jcfg, loss_chunk=chunk))
    with pytest.raises(AssertionError, match="seq 192 not divisible by loss chunk 128"):
        loss(0)(jparams, jbatch)
    want = float(loss(64)(jparams, jbatch))
    api = build(get_smoke("whisper-base").replace(vocab_size=257, dtype="float32"), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got = api.train_loss(params, to_device(batch, "cpu", torch.float32)).item()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)   # _tol, float32
