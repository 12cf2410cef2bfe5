"""The port's static analysis (``repro_torch.analysis``) against the reference's.

Both packages' determinism lint (``lint_source``) and purity verifier
(``analyze_callable``) run over the reference's own test corpus (the
fixture payloads and lint snippets of ``tests/test_analysis.py``) and over
every file of ``src/repro/core/``; their findings (rule, severity, line,
function, message, waiver) must be equal. The composition lint runs on
the same bad graph in both.

The port's one change is the ``rng`` rule on torch's global generator,
which a torch payload has and a JAX payload has not: ``torch.rand`` and
its kin without ``generator=``, and ``torch.manual_seed`` / ``torch.seed``.

The gate of ``tests/test_analysis.py::test_repo_source_is_unwaived_clean``
holds for the port: ``lint_paths([src/repro_torch])`` has no unwaived
finding, and every waiver has a reason.
"""
import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("repro", "repro_torch")
CORE_FILES = sorted((ROOT / "src" / "repro" / "core").glob("*.py"))


def _analysis(name: str):
    return importlib.import_module(f"{name}.analysis")


def _plain(findings):
    return [(f.rule, f.severity, f.file, f.line, f.function, f.message, f.waived,
             f.waive_reason) for f in findings]


def _reference_corpus():
    """``FIXTURE_SOURCE`` and every literal ``src = ...`` snippet of
    tests/test_analysis.py, read from its syntax tree."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    corpus = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)):
            name = node.targets[0].id
            if name in ("FIXTURE_SOURCE", "src"):
                corpus[f"{name}@{node.lineno}"] = node.value.value
    return corpus


CORPUS = _reference_corpus()


@pytest.fixture(scope="module")
def fixture_mod(tmp_path_factory):
    """The reference's fixture payloads, imported from a real file."""
    path = tmp_path_factory.mktemp("analysis") / "torch_purity_fixtures.py"
    path.write_text(CORPUS[next(k for k in CORPUS if k.startswith("FIXTURE_SOURCE"))])
    spec = importlib.util.spec_from_file_location("torch_purity_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_was_found():
    assert len(CORPUS) >= 6 and any(k.startswith("FIXTURE_SOURCE") for k in CORPUS)


@pytest.mark.parametrize("key", sorted(CORPUS))
def test_lint_source_equal_on_the_reference_corpus(key):
    ref, port = (_plain(_analysis(n).lint_source(CORPUS[key], "corpus.py")) for n in PACKAGES)
    assert port == ref


@pytest.mark.parametrize("depth", (0, 1, 2))
def test_analyze_callable_equal_on_the_reference_fixtures(fixture_mod, depth):
    fns = sorted(n for n, v in vars(fixture_mod).items()
                 if callable(v) and getattr(v, "__module__", "") == fixture_mod.__name__)
    assert len(fns) > 20
    got = {}
    for name in PACKAGES:
        analysis = _analysis(name)
        analysis.clear_cache()
        got[name] = {fn: _plain(analysis.analyze_callable(getattr(fixture_mod, fn), depth=depth))
                     for fn in fns}
    assert got["repro_torch"] == got["repro"]
    assert any(got["repro"].values())


@pytest.mark.parametrize("path", CORE_FILES, ids=lambda p: p.name)
def test_lint_source_equal_on_reference_core(path):
    text = path.read_text()
    ref, port = (_plain(_analysis(n).lint_source(text, str(path.relative_to(ROOT))))
                 for n in PACKAGES)
    assert port == ref


def test_lint_paths_equal_on_the_reference_package():
    ref, port = (_analysis(n).lint_paths([ROOT / "src" / "repro"]) for n in PACKAGES)
    assert _plain(port.findings) == _plain(ref.findings)
    assert ref.findings and not port.unwaived


def test_graph_lint_equal():
    got = []
    for name in PACKAGES:
        dag = importlib.import_module(f"{name}.core.dag")
        c = dag.Composition("bad")
        a = c.compute("a", "fa", inputs=("i",), outputs=("o",))
        c.compute("island", "fb", inputs=(), outputs=("o2",))
        h = c.http("h")
        c.vertices["h"].retry = dag.RetryPolicy(max_retries=3)
        c.bind_input("in", a["i"])
        c.edge(a["o"], h["requests"], mode="each")
        c.bind_output("out", h["responses"])
        got.append([_plain(_analysis(name).lint_composition(c, cluster=cl, crossnode=cn).findings)
                    for cl, cn in ((False, False), (True, False), (True, True))])
    assert got[1] == got[0]
    assert len(got[1][1]) == 4


def test_port_source_is_unwaived_clean():
    """The counterpart of tests/test_analysis.py's gate, over the port."""
    report = _analysis("repro_torch").lint_paths([ROOT / "src" / "repro_torch"])
    assert report.unwaived == [], report.render(show_waived=False)
    assert report.waived and all(f.waive_reason for f in report.waived)


def test_detlint_cli_defaults_to_the_port(capsys):
    from repro_torch.analysis import detlint

    assert detlint.main(["-q"]) == 0
    assert detlint.main([str(ROOT / "src" / "repro_torch" / "core")]) == 0
    assert "core/engines.py" not in capsys.readouterr().out  # waived, not listed


# ------------------------------------------------------- torch's generator
TORCH_FLAGGED = (
    "torch.rand(3)", "torch.randn(2, 3)", "torch.randint(0, 10, (4,))", "torch.randperm(8)",
    "torch.normal(0.0, 1.0, (3,))", "torch.bernoulli(p)", "torch.multinomial(p, 2)",
    "torch.manual_seed(0)", "torch.seed()", "torch.manual_seed(0, generator=g)",
)
TORCH_CLEAN = (
    "torch.rand(3, generator=g)", "torch.randn(2, 3, generator=g)",
    "torch.randint(0, 10, (4,), generator=g)", "torch.randperm(8, generator=g)",
    "torch.normal(0.0, 1.0, (3,), generator=g)", "torch.bernoulli(p, generator=g)",
    "torch.multinomial(p, 2, generator=g)", "torch.Generator().manual_seed(0)",
    "g.manual_seed(0)", "torch.zeros(3)", "torch.cuda.manual_seed(0)",
)


def _snippet(call: str, header: str = "import torch") -> str:
    return f"{header}\ndef f(p, g):\n    return {call}\n"


@pytest.mark.parametrize("call", TORCH_FLAGGED)
def test_torch_global_generator_is_flagged(call):
    port = _analysis("repro_torch").lint_source(_snippet(call), "t.py")
    assert [(f.rule, f.line) for f in port] == [("rng", 3)]
    assert "generator" in port[0].message
    # the reference's rule knows numpy's and the stdlib's global generators only
    assert _analysis("repro").lint_source(_snippet(call), "t.py") == []


@pytest.mark.parametrize("call", TORCH_CLEAN)
def test_torch_call_with_a_generator_is_not_flagged(call):
    assert _analysis("repro_torch").lint_source(_snippet(call), "t.py") == []


@pytest.mark.parametrize("header,call", [
    ("import torch as T", "T.randn(3)"),
    ("from torch import randn", "randn(3)"),
    ("from torch import manual_seed as ms", "ms(1)"),
])
def test_torch_aliases_resolve(header, call):
    findings = _analysis("repro_torch").lint_source(_snippet(call, header), "t.py")
    assert [f.rule for f in findings] == ["rng"]


def test_torch_payload_purity(tmp_path):
    """A payload that draws from torch's global generator is impure; one that
    draws from a seeded generator is not."""
    path = tmp_path / "torch_payloads.py"
    path.write_text("import torch\n\n"
                    "def noisy(ins):\n    return {'out': [torch.randn(4)]}\n\n"
                    "def seeded(ins):\n"
                    "    g = torch.Generator().manual_seed(0)\n"
                    "    return {'out': [torch.randn(4, generator=g)]}\n")
    spec = importlib.util.spec_from_file_location("torch_payloads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    analysis = _analysis("repro_torch")
    (f,) = analysis.analyze_callable(mod.noisy)
    assert (f.rule, f.line, f.function) == ("rng", 4, "noisy")
    assert analysis.analyze_callable(mod.seeded) == []


def test_serving_payload_analysis_is_bounded():
    """``generate`` closes over a batcher; the callee recursion follows plain
    functions of its own package only, so it stops at the payload's body."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.serving.batching import ContinuousBatcher
    from repro_torch.serving.serve_lm import _generate_fn

    api = build(get_smoke("granite-8b").replace(dtype="float32"), device="cpu")
    batcher = ContinuousBatcher(api, api.init_params(torch.Generator().manual_seed(0)),
                                num_slots=1, cache_len=16)
    analysis = _analysis("repro_torch")
    analysis.clear_cache()
    findings = analysis.analyze_callable(_generate_fn(batcher, 2), name="generate")
    assert {f.rule for f in findings} == {"global-mutation"}
    assert all(f.function == "generate" and "serve_lm.py" in f.file for f in findings)
