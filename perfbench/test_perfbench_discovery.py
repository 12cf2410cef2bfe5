"""A configuration, a cell and a per-layer metric are each added by adding a file,
which the harness finds by name: here dropped into a copy of the tree."""
import json
import shutil

import pytest

from perfbench import costs, harness
from perfbench.smoke import ROOT
from perfbench.tracing import DeviceTrace


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench" / "configs" / "granite-8b.json").read_text())
    (tmp_path / "perfbench" / "configs" / "new-model.json").write_text(
        json.dumps(dict(cfg, name="new-model", num_hidden_layers=3)))
    cell = json.loads((ROOT / "perfbench" / "workloads" / "granite-8b.serve.rag.json").read_text())
    cell.update(config="new-model", traffic="bursty")
    cell["arrivals"]["rate_per_s"] = 1.5
    (tmp_path / "perfbench" / "workloads" / "new-model.serve.bursty.json").write_text(json.dumps(cell))
    (tmp_path / "perfbench" / "metrics" / "slot_share.py").write_text(
        "def read(name, record):\n    return record.counters.get('slots')\n")
    bench["workloads"].append({"name": "new-model.serve.bursty", "config": "new-model",
                               "traffic": "bursty", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "slot_share.serve", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "scheduler", "moves": "ttft_p90_ms",
                               "workloads": ["new-model.serve.bursty"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "granite-8b.serve.rag" in m["workloads"]:
            m["workloads"].append("new-model.serve.bursty")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got_cell, got_cfg = harness.cell_files(tmp_path, "new-model.serve.bursty")
    assert got_cfg["num_hidden_layers"] == 3 and got_cell["arrivals"]["rate_per_s"] == 1.5
    names = [m["name"] for m in harness.metrics_for(bench, "new-model.serve.bursty", True)]
    assert "slot_share.serve" in names and "flash_attention_roofline.serve" not in names
    assert {m["name"] for m in harness.metrics_for(bench, "new-model.serve.bursty", False)} == \
        {"ttft_p90_ms", "setup_s"}
    read = harness.reader_for("slot_share.serve", tmp_path / "perfbench" / "metrics")
    assert read("slot_share.serve", harness.Record({}, {}, counters={"slots": 42.0})) == 42.0
    # a kernel's roofline reader takes it in every kind of cell
    for kind in ("serve", "batch", "train"):
        assert harness.reader_for(f"rmsnorm_roofline.{kind}", tmp_path / "perfbench" / "metrics") is not None
    assert harness.reader_for("no_such_metric.serve", tmp_path / "perfbench" / "metrics") is None
    read = harness.reader_for("tpot_p90_ms.serve", tmp_path / "perfbench" / "metrics")
    assert read("tpot_p90_ms.serve", harness.Record({}, {}, counters={"tpots": [0.05] * 9 + [0.15]})) == \
        pytest.approx(60.0)
    assert read("tpot_p90_ms.serve", harness.Record({}, {})) is None


def _traced(kernel_costs, kernels):
    record = harness.Record({}, {}, kernel_costs=kernel_costs,
                            device=DeviceTrace(0, 10 ** 9, kernels, []))
    return harness.Outcome({}, record, [], 1, 0, 0)


def test_a_traced_run_fails_where_a_listed_metric_reads_nothing():
    metric = [{"name": "rmsnorm_roofline.serve", "unit": "%"}]
    call = costs.rmsnorm(1024 * 4096, 4096, 2)
    line, _ = harness.result_line(_traced({"rmsnorm": [call]}, [("rmsnorm_kernel<bf16>", 0, 10 ** 6)]),
                                  metric, True, {})
    assert line["metrics"]["rmsnorm_roofline.serve"]["value"] == pytest.approx(100 * call.bound_s() / 1e-3)
    # called, but no device kernel matched to it (a renamed symbol): no result
    with pytest.raises(RuntimeError, match="rmsnorm"):
        harness.result_line(_traced({"rmsnorm": [call]}, [("renamed_norm", 0, 10 ** 6)]), [], True, {})
    # a metric the cell lists that reads nothing: no result
    with pytest.raises(RuntimeError, match="rmsnorm_roofline.serve"):
        harness.result_line(_traced({}, []), metric, True, {})
