"""The control, at a size a test run holds: the plain reference in the precision below
the configuration's (float8 e4m3 for bfloat16) put in the program's place reads
further from the float32 reference than the program does, by the margin the limits
sit in."""
import pytest

from perfbench import harness
from perfbench.runners import serve, train
from perfbench.smoke import smoke_cell, smoke_config


def test_the_served_control_reads_above_the_program(cpu_threads):
    cell, cfg = smoke_cell("granite-8b.serve.rag"), smoke_config("granite-8b")
    seed = 2 ** 36 + 1
    out = serve.run(cell, cfg, seed, 1.0, False, "cpu", 0.0)
    program = out.checks[0].value
    control = max(float(g.max()) for g in serve.token_gaps(cfg, seed, out.served, "cpu", quant="fp8"))
    assert control >= 3 * program, (program, control)


@pytest.mark.parametrize("name", ["olmoe-1b-7b.train.4k", "granite-8b.train.4k"])
def test_the_training_control_reads_above_the_program(name, cpu_threads):
    cell = smoke_cell(name)
    cfg = smoke_config(harness.load_json(harness.HERE / "workloads" / f"{name}.json")["config"])
    seed = 2 ** 36 + 2
    want = train.reference_steps(cell, cfg, seed, "cpu")
    got = train.program_steps(cell, cfg, seed, 0.2, False, "cpu", 0.0)[2]
    ctrl = train.reference_steps(cell, cfg, seed, "cpu", quant="fp8")
    prog = {c.name: c.value for c in train.compare(cell, got, want)}
    low = {c.name: c.value for c in train.compare(cell, ctrl, want)}
    assert any(low[k] >= 3 * prog[k] for k in prog), (prog, low)
