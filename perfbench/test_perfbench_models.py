"""What a configuration brings to the benchmark is found by name: its reference module
(``"reference"``), the program's fields (``"program"``), its model arithmetic and smoke
sizes (the module's), and a kernel's count (``perfbench/kernels/<kernel>.py``). An
architecture the reference did not have (an MoE with a shared SwiGLU expert beside the
routed ones) and a kernel the harness did not count are each added by files alone,
into a copy of the tree; the existing configurations read as they did."""
import dataclasses
import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import costs, program, tracing
from perfbench.harness import Record, reader_for
from perfbench.reference import for_config, forbidden_imports, model
from perfbench.smoke import ROOT, smoke_config
from perfbench.tracing import DeviceTrace, KernelCalls, kernel_files, kernel_of

CONFIGS = ["granite-8b", "granite-8b-16l", "olmoe-1b-7b"]

# the smoke sizes smoke.py applied by family before the reference modules gave them
PARENT_SMOKE = {
    "dense": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=160, num_attention_heads=8,
                  num_key_value_heads=2, head_dim=8, vocab_size=256),
    "moe": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=32, num_attention_heads=4,
                num_key_value_heads=4, head_dim=16, vocab_size=256, num_experts=8,
                num_experts_per_tok=2),
}

SHARED_LINE = '    y = y + swiglu(x, mp["shared_gate"], mp["shared_up"], mp["shared_down"], quant)\n'

# the toy architecture's reference: model.py's MoE, every token also through a shared
# SwiGLU expert of width ``shared_expert_intermediate_size``
TOY = '''"""model.py's MoE decoder with a shared SwiGLU expert beside the routed ones."""
from dataclasses import dataclass, fields

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference import model
from perfbench.reference.model import (LOSS_ROWS, SMOKE, _xent_sum, attention, cache_bytes,  # noqa: F401
                                       decode_flops, draw_leaf, draw_weights, head_weight,
                                       layer_params, leaves, mm, no_tf32, prefill_flops,
                                       rms_norm, split_layers, swiglu, train_flops)


@dataclass(frozen=True)
class Arch(model.Arch):
    shared: int = 0
    dtype: str = "bfloat16"

    @staticmethod
    def from_config(c):
        base = model.Arch.from_config(c)
        return Arch(**{f.name: getattr(base, f.name) for f in fields(base)},
                    shared=int(c["shared_expert_intermediate_size"]), dtype=c["torch_dtype"])


def weight_spec(a):
    """model.py's leaves in the configuration's dtype (the router float32), the shared
    expert's beside the routed experts'."""
    dt = getattr(torch, a.dtype)
    spec = [(p, s, t if t == torch.float32 else dt, i) for p, s, t, i in model.weight_spec(a)]
    L, d, f = a.layers, a.d, a.shared
    shared = [(("blocks", "moe", "shared_gate"), (L, d, f), dt, f"normal:{d ** -0.5}"),
              (("blocks", "moe", "shared_up"), (L, d, f), dt, f"normal:{d ** -0.5}"),
              (("blocks", "moe", "shared_down"), (L, f, d), dt, f"normal:{f ** -0.5}")]
    return spec[:-1] + shared + spec[-1:] if not a.tied else spec + shared


def make_leaf(a, seed, path, device):
    return draw_leaf(weight_spec(a), seed, path, device)


def make_weights(a, seed, device):
    return draw_weights(weight_spec(a), seed, device)


def ffn(x, lp, a, quant):
    y, aux = model.ffn(x, lp, a, quant)
    mp = lp["moe"]
''' + SHARED_LINE + '''    return y, aux


def block(h, lp, a, quant, grad):
    h = h + attention(rms_norm(h, lp["norm1"], a.eps), lp["attn"], a, quant, grad)
    y, aux = ffn(rms_norm(h, lp["norm2"], a.eps), lp, a, quant)
    return h + y, aux


def hidden(params, tokens, a, quant=None, grad=False):
    h = params["embed"].float()[tokens.long()]
    aux = h.new_zeros(())
    for i in range(a.layers):
        lp = layer_params(params, i)
        if grad:
            h, la = checkpoint(block, h, lp, a, quant, grad, use_reentrant=False)
        else:
            h, la = block(h, lp, a, quant, grad)
        aux = aux + la / a.layers
    return rms_norm(h, params["final_norm"], a.eps), aux


def train_loss(params, tokens, targets, a, quant=None):
    h, aux = hidden(params, tokens, a, quant, grad=True)
    w = head_weight(params, a)
    total = h.new_zeros(())
    for c0 in range(0, h.shape[1], LOSS_ROWS):
        total = total + checkpoint(_xent_sum, h[:, c0:c0 + LOSS_ROWS], w,
                                   targets[:, c0:c0 + LOSS_ROWS], quant, use_reentrant=False)
    return total / targets.numel() + a.aux_weight * aux


@torch.no_grad()
def next_token_logits(params, tokens, rows, a, quant=None):
    h, _ = hidden(params, tokens[None], a, quant)
    return mm(h[0, rows.long()], head_weight(params, a).float(), quant)
'''

# run from the copy's root: the smoke cells of the toy architecture through the runners,
# with the toy reference and with its copy that leaves the shared expert out
RUN = '''
import json, sys
sys.path[0:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
from perfbench import harness
from perfbench.reference import for_config
from perfbench.runners import serve, train
from perfbench.smoke import smoke_cell, smoke_config

cfg = smoke_config("toy-shared")
out = {{"module": for_config(cfg).__name__, "file": for_config(cfg).__file__}}
for ref in ("toy_shared", "toy_no_shared"):
    c = dict(cfg, reference=ref)
    for kind, run in (("serve", lambda: serve.run(smoke_cell("toy-shared.serve.rag"), c, {seed}, 1.0,
                                                  False, "cpu", 0.0)),
                      ("train", lambda: train.run(smoke_cell("toy-shared.train.4k"), c, {seed}, 0.2,
                                                  False, "cpu", 0.0))):
        o = run()
        out[ref + "." + kind] = {{"correct": harness.result_line(o, [], False, {{}})[0]["correct"],
                                 "checks": {{k.name: [k.value, k.limit] for k in o.checks}}}}
print(json.dumps(out))
'''


def _parent_model_config(config: dict):
    """``program.model_config`` as it was before the ``"program"`` block."""
    from repro_torch.config import ModelConfig
    moe = int(config.get("num_experts", 0)) > 0
    return ModelConfig(
        name=config["name"], family="moe" if moe else "dense",
        num_layers=int(config["num_hidden_layers"]), d_model=int(config["hidden_size"]),
        num_heads=int(config["num_attention_heads"]),
        num_kv_heads=int(config["num_key_value_heads"]), d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]), head_dim=int(config["head_dim"]),
        rope_theta=float(config["rope_theta"]), norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config["tie_word_embeddings"]), dtype=config["torch_dtype"],
        num_experts=int(config.get("num_experts", 0)),
        experts_per_token=int(config.get("num_experts_per_tok", 0)),
        moe_capacity_factor=float(config.get("moe_capacity_factor", 1.25)))


def _config(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_the_existing_configurations_read_as_before(name):
    cfg = _config(name)
    ref = for_config(cfg)
    assert ref is model
    for n in (1, 700, 1800, 4096):
        assert ref.prefill_flops(cfg, n) == costs.prefill_flops(cfg, n)
        assert ref.decode_flops(cfg, n) == costs.decode_flops(cfg, n)
    assert ref.train_flops(cfg, 8, 4096) == costs.train_flops(cfg, 8, 4096)
    cell = {"slots": 64, "cache_len": 4096}
    assert ref.cache_bytes(cfg, cell) == (2 * 2 * 64 * 4096 * cfg["num_hidden_layers"]
                                          * cfg["num_key_value_heads"] * cfg["head_dim"])
    assert smoke_config(name) == dict(cfg, **PARENT_SMOKE["moe" if cfg.get("num_experts") else "dense"])
    assert program.model_config(cfg) == _parent_model_config(cfg)
    assert program.model_config(smoke_config(name)) == _parent_model_config(smoke_config(name))


def test_the_program_block_sets_the_ports_fields():
    cfg = smoke_config("olmoe-1b-7b")
    block = {"shared_expert_d_ff": 48, "global_attn_layers": [0, 1], "family": "hybrid"}
    got = program.model_config(dict(cfg, program=block))
    assert got == dataclasses.replace(program.model_config(cfg), shared_expert_d_ff=48,
                                      global_attn_layers=(0, 1), family="hybrid")
    with pytest.raises(ValueError, match="'no_such_field'"):
        program.model_config(dict(cfg, program={"shared_expert_d_ff": 48, "no_such_field": 1}))


def test_a_reference_module_is_refused_for_what_it_imports(tmp_path):
    assert forbidden_imports(ROOT / "perfbench" / "reference" / "model.py") == []
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef f():\n    import jax.numpy\n    from repro.models import moe\n")
    assert forbidden_imports(bad) == ["jax", "repro"]
    # through the benchmark's own modules: program.py loads the program
    bad.write_text("from perfbench import program\n")
    assert forbidden_imports(bad) == ["repro_torch"]
    # a relative import, resolved in the module's own package
    (tmp_path / "perfbench" / "reference").mkdir(parents=True)
    (tmp_path / "perfbench" / "helper.py").write_text("import flax\n")
    rel = tmp_path / "perfbench" / "reference" / "rel.py"
    rel.write_text("from . import model\nfrom ..helper import x\n")
    assert forbidden_imports(rel, tmp_path) == ["flax"]
    with pytest.raises(ValueError, match="no_such_module"):
        for_config({"reference": "no_such_module"})


def test_an_architecture_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "reference" / "toy_shared.py").write_text(TOY)
    assert SHARED_LINE in TOY
    (pb / "reference" / "toy_no_shared.py").write_text(TOY.replace(SHARED_LINE, ""))
    # float32, where the program and the reference agree to rounding at the smoke size, so
    # the real cells' limits hold; a capacity that drops no assignment, as the served
    # program routes other groups (the prefill's padded prompt, a decode step's slots)
    # than the reference's one sequence
    (pb / "configs" / "toy-shared.json").write_text(json.dumps(dict(
        _config("olmoe-1b-7b"), name="toy-shared", reference="toy_shared", torch_dtype="float32",
        moe_capacity_factor=4.0, shared_expert_intermediate_size=48,
        program={"shared_expert_d_ff": 48})))
    for src, traffic in (("granite-8b.serve.rag", "serve.rag"), ("olmoe-1b-7b.train.4k", "train.4k")):
        cell = json.loads((pb / "workloads" / f"{src}.json").read_text())
        (pb / "workloads" / f"toy-shared.{traffic}.json").write_text(
            json.dumps(dict(cell, config="toy-shared", traffic=traffic.split(".")[1])))
    assert all(p.read_bytes() == b for p, b in before.items())     # no file edited

    code = RUN.format(root=str(tmp_path), src=str(ROOT / "src"), seed=2 ** 35 + 11)
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["module"] == "perfbench.reference.toy_shared"
    assert out["file"].startswith(str(tmp_path))
    for kind in ("serve", "train"):
        assert out[f"toy_shared.{kind}"]["correct"], out[f"toy_shared.{kind}"]
        assert not out[f"toy_no_shared.{kind}"]["correct"], out[f"toy_no_shared.{kind}"]
    gap, limit = out["toy_no_shared.serve"]["checks"]["widest_logit_gap"]
    assert gap > limit
    gap, limit = out["toy_no_shared.train"]["checks"]["loss_gap"]
    assert gap > limit


# a kernel file of the test: ``ops.ssd`` counted with the forward's sizes and, as a
# device scalar, the positions whose log decay is below -1
TEST_KERNEL = '''
import torch
from perfbench.costs import Cost

SYMBOLS = ("ssd_chunk_kernel",)
WRAP = (("repro_torch.kernels.ops", "ssd"),)


def record(x, a, b, c, *, chunk):
    return (x.shape[0], x.shape[1], min(chunk, x.shape[1])), torch.stack([(a < -1).sum()])


def cost(sizes, counts):
    return Cost(float(sizes[0] * sizes[1] * sizes[2]), float(counts[0]), "float32")
'''


def _ssd_inputs(bsz=1, s=16, h=2, p=4, n=3):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(bsz, s, h, p, generator=g)
    a = -2 * torch.rand(bsz, s, h, generator=g)
    b, c = torch.randn(bsz, s, n, generator=g), torch.randn(bsz, s, n, generator=g)
    return x, a, b, c


def _builtin_calls():
    """Built-in kernels' calls and an ``ssd`` call, recorded with the kernel files."""
    from repro_torch.kernels import ops
    calls = KernelCalls()
    calls.install()
    try:
        ops.rmsnorm(torch.randn(3, 8), torch.ones(8))
        ops.moe_gmm(torch.randn(3, 4, 2), torch.randn(3, 2, 5),
                    torch.tensor([[2], [3], [0]], dtype=torch.int32))
        ops.ssd(*_ssd_inputs(), chunk=8)
    finally:
        calls.remove()
    return calls.costs()


def test_a_kernel_file_is_counted_and_matched(tmp_path, monkeypatch, cpu_threads):
    from repro_torch.kernels import ops
    (tmp_path / "k").mkdir()
    (tmp_path / "k" / "ssd.py").write_text(TEST_KERNEL)
    monkeypatch.setattr(tracing, "KERNELS_DIR", tmp_path / "k")
    x, a, b, c = _ssd_inputs()
    got = _builtin_calls()
    assert got["ssd"] == [costs.Cost(1 * 16 * 8, float((a < -1).sum()), "float32")]
    assert ops.ssd.__name__ == "ssd"                       # removed again
    assert kernel_of("void ssd_chunk_kernel<float, 64>") == "ssd"
    assert kernel_of("void rmsnorm_kernel<bf16>") == "rmsnorm"
    ms = 1_000_000
    trace = DeviceTrace(0, 100 * ms, [("void ssd_chunk_kernel<float>", 0, 4 * ms),
                                      ("void rmsnorm_kernel<bf16>", 10 * ms, 12 * ms)], [])
    assert trace.kernel_seconds() == {"ssd": pytest.approx(0.004), "rmsnorm": pytest.approx(0.002)}
    # each call bounded at the peak of its own operands' type
    rec = Record({}, {}, kernel_costs={"ssd": [costs.Cost(67e9, 1.0, "float32"),
                                               costs.Cost(989e9, 1.0, "bfloat16")]}, device=trace)
    assert reader_for("ssd_roofline.train")("ssd_roofline.train", rec) == pytest.approx(50.0)

    # with no kernel files: the built-in calls and seconds alone, as before
    monkeypatch.setattr(tracing, "KERNELS_DIR", tmp_path / "none")
    assert kernel_of("void ssd_chunk_kernel<float, 64>") is None
    none = _builtin_calls()
    assert "ssd" not in none and none == {k: v for k, v in got.items() if k != "ssd"}
    assert none["rmsnorm"] == [costs.rmsnorm(24, 8, 4)]
    assert none["moe_gmm"] == [costs.moe_gmm(3, 4, 2, 5, 4, rows=5, experts=2)]
    bare = DeviceTrace(0, 100 * ms, trace.kernels, [])
    assert bare.kernel_seconds() == {"rmsnorm": pytest.approx(0.002)}


@pytest.mark.parametrize("symbols", [("rmsnorm_kernel_v2",), ("ssd_",), ("bwd_",)])
def test_a_kernel_file_whose_symbols_overlap_fails_at_load(tmp_path, monkeypatch, symbols):
    (tmp_path / "a_first.py").write_text(TEST_KERNEL)
    (tmp_path / "b_second.py").write_text(TEST_KERNEL.replace('("ssd_chunk_kernel",)', repr(symbols)))
    monkeypatch.setattr(tracing, "KERNELS_DIR", tmp_path)
    with pytest.raises(ValueError, match="b_second.py"):
        kernel_files()


@pytest.mark.parametrize("name", ["void rmsnorm_kernel_ssd_chunk_kernel<float>",
                                  "void ssd_chunk_kernel_scan_tail<float>"])
def test_a_device_kernel_that_two_kernels_match_fails(tmp_path, monkeypatch, name):
    """Symbols that hold no one another can still meet in one name: a built-in's and a
    file's, or two files'."""
    (tmp_path / "a_first.py").write_text(TEST_KERNEL)
    (tmp_path / "b_second.py").write_text(TEST_KERNEL.replace('("ssd_chunk_kernel",)',
                                                              '("scan_tail",)'))
    monkeypatch.setattr(tracing, "KERNELS_DIR", tmp_path)
    with pytest.raises(ValueError, match="matches the kernels"):
        kernel_of(name)
    with pytest.raises(ValueError, match="matches the kernels"):
        DeviceTrace(0, 10, [(name, 0, 5)], []).kernel_seconds()


@pytest.mark.parametrize("shape", [(1, 1024, 24, 64, 128), (1, 2048, 50, 64, 16),
                                   (2, 4096, 24, 64, 128), (2, 4096, 50, 64, 16)],
                         ids=["mamba2", "hymba", "mamba2-train", "hymba-train"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_ssd_files_cost_what_the_port_counts(shape, dtype):
    """The frozen copies against the port's ``cost`` and ``backward_cost`` at mamba2's and
    hymba's shapes (chunk 128), each bounded at the peak of x's dtype."""
    from repro_torch.kernels import ssd as kssd
    bsz, s, h, p, n = shape
    x = torch.empty(bsz, s, h, p, dtype=dtype, device="meta")
    a = torch.empty(bsz, s, h, device="meta")
    b = torch.empty(bsz, s, n, dtype=dtype, device="meta")
    files = {f.name: f for f in kernel_files()}
    assert [f.name for f in kernel_files()] == ["ssd", "ssd_backward"]
    fwd, bwd = files["ssd"], files["ssd_backward"]
    peak = str(dtype).removeprefix("torch.")
    got = fwd.cost(fwd.record(x, a, b, b, chunk=128)[0], None)
    assert got == (*kssd.cost(x, a, b, b, chunk=128), peak)
    assert got.bound_s() == max(got.bytes / costs.HBM_BYTES_PER_S, got.flops / costs.PEAK_FLOPS[peak])
    for dhf in (None, torch.empty(bsz, h, p, n, device="meta")):
        port = kssd.backward_cost(x, a, b, b, chunk=128, dhf=dhf is not None)
        plain_args, kernel_args = (x, a, b, b, x, dhf, 128), (x, a, b, b, x, dhf, a, a, a, a)
        for args, kw in ((plain_args, {}), (kernel_args, {"chunk": 128})):
            assert bwd.cost(bwd.record(*args, **kw)[0], None) == (*port, peak)


def test_the_ssd_files_record_the_ports_calls(cpu_threads):
    """Forward and backward, through ``ops.ssd`` and ``SSDFunction`` on the CPU."""
    from repro_torch.kernels import ops
    x, a, b, c = _ssd_inputs(bsz=2, s=32, h=3, p=4, n=5)
    x.requires_grad_(True)
    calls = KernelCalls()
    calls.install()
    try:
        y, hf = ops.ssd(x, a, b, c, chunk=16)
        y.sum().backward()
    finally:
        calls.remove()
    got = calls.costs()
    files = {f.name: f for f in kernel_files()}
    assert got["ssd"] == [files["ssd"].cost((2, 32, 3, 4, 5, 16, 4, "float32"), None)]
    assert got["ssd_backward"] == [files["ssd_backward"].cost((2, 32, 3, 4, 5, 16, 4, False,
                                                                "float32"), None)]
