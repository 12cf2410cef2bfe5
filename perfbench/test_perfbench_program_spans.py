"""The readers of the program's own spans and counters (``repro_torch.core.tracing``):
each on a hand-made record against the hand-worked value, and None where the program
recorded nothing for it; then each on a traced run of its cells on the CPU, at the
smoke size."""
import pytest

torch = pytest.importorskip("torch")

from perfbench import stats  # noqa: E402
from perfbench.harness import Record, reader_for  # noqa: E402
from perfbench.runners import serve, train  # noqa: E402
from perfbench.smoke import smoke_cell, smoke_config  # noqa: E402
from perfbench.tracing import DeviceTrace  # noqa: E402
from repro_torch.core import tracing  # noqa: E402

MS = 1_000_000


def _trace(host):
    # kernels busy 10-30 and 50-60 of a 100 ms window, one of them inside another
    return DeviceTrace(0, 100 * MS, [("k1", 10 * MS, 30 * MS), ("k2", 12 * MS, 14 * MS),
                                     ("k3", 50 * MS, 60 * MS)], host)


def _read(name, record):
    return reader_for(name)(name, record)


def test_decode_busy_share():
    decode = "repro_torch.batcher.decode"
    rec = Record({}, {}, device=_trace([(decode, 0, 20 * MS), (decode, 55 * MS, 75 * MS),
                                        ("repro_torch.batcher.step", 0, 80 * MS)]))
    # 10 of the first 20 ms, 5 of the second 20
    assert _read("decode_busy_share.serve", rec) == pytest.approx(100 * 15 / 40)
    assert _read("decode_busy_share.batch", Record({}, {}, device=_trace([]))) is None
    assert _read("decode_busy_share.batch", Record({}, {})) is None


def test_decode_busy_share_is_the_union_clipped_to_each_span():
    g = torch.Generator().manual_seed(3)
    starts = torch.randint(0, 10 ** 6, (400,), generator=g).tolist()
    lengths = torch.randint(1, 5000, (400,), generator=g).tolist()
    kernels = [("k", s, s + n) for s, n in zip(starts, lengths)]
    spans = [(s, s + 20000) for s in range(0, 10 ** 6, 50000)]
    rec = Record({}, {}, device=DeviceTrace(0, 10 ** 6 + 5000, kernels,
                                            [("repro_torch.batcher.decode", s, e) for s, e in spans]))
    want = sum(stats.union_length(((s, e) for _, s, e in kernels), lo, hi) for lo, hi in spans)
    assert _read("decode_busy_share.serve", rec) == pytest.approx(100 * want / (20000 * len(spans)))


def test_device_idle_outside_program():
    rec = Record({}, {}, device=_trace([("repro_torch.train.step", 25 * MS, 45 * MS),
                                        ("repro_torch.train.clip", 90 * MS, 95 * MS)]))
    # covered: 10-45 by kernels and the step, 50-60 by a kernel; a nested span counts not
    assert _read("device_idle_outside_program.train", rec) == pytest.approx(55.0)
    serve_rec = Record({}, {}, device=_trace([("repro_torch.batcher.step", 0, 12 * MS)]))
    assert _read("device_idle_outside_program.serve", serve_rec) == pytest.approx(60.0)
    assert _read("device_idle_outside_program.batch", Record({}, {}, device=_trace([]))) is None
    assert _read("device_idle_outside_program.train", Record({}, {})) is None


def test_the_counter_readers(monkeypatch):
    seconds = {"repro_torch.train.step": 2.0, "repro_torch.train.clip": 0.05,
               "repro_torch.train.adamw": 0.15, "repro_torch.moe.route": 0.01,
               "repro_torch.moe.route.backward": 0.02, "repro_torch.moe.dispatch": 0.1,
               "repro_torch.moe.dispatch.backward": 0.2, "repro_torch.moe.combine": 0.03,
               "repro_torch.moe.combine.backward": 0.04, "repro_torch.moe.experts": 0.5}
    monkeypatch.setattr(tracing, "device_seconds", lambda: dict(seconds))
    rec = Record({}, {})
    assert _read("optimizer_share.train", rec) == pytest.approx(10.0)
    assert _read("moe_dispatch_share.train", rec) == pytest.approx(100 * 0.4 / 2.0)
    del seconds["repro_torch.moe.combine.backward"]
    assert _read("moe_dispatch_share.train", rec) is None
    seconds.clear()
    assert _read("optimizer_share.train", rec) is None
    # a program whose tracer counts no device seconds: nothing, and no error
    monkeypatch.delattr(tracing, "device_seconds")
    assert _read("optimizer_share.train", rec) is None
    assert _read("moe_dispatch_share.train", rec) is None


# The cells each reader is written for. They are not listed in ``BENCHMARK.json``:
# ``harness.result_line`` fails a traced run whose listed metric reads nothing, as
# these do on a program without the spans.
CELLS = {
    "granite-8b.serve.rag": ["decode_busy_share.serve", "device_idle_outside_program.serve"],
    "granite-8b.batch.chat": ["decode_busy_share.batch", "device_idle_outside_program.batch"],
    "olmoe-1b-7b.train.4k": ["device_idle_outside_program.train", "optimizer_share.train",
                             "moe_dispatch_share.train"],
}


@pytest.mark.parametrize("cell,config", [("granite-8b.serve.rag", "granite-8b"),
                                         ("granite-8b.batch.chat", "granite-8b"),
                                         ("olmoe-1b-7b.train.4k", "olmoe-1b-7b")])
def test_a_traced_run_reads_every_new_metric_of_its_cell(cell, config, cpu_threads, monkeypatch):
    monkeypatch.setattr(tracing._clock, "seconds", {})   # this run's counts only
    cfg = smoke_config(config)
    c = smoke_cell(cell)
    if c["runner"] == "serve":
        record = serve.run(c, cfg, 2 ** 33 + 5, 2.0, True, "cpu", 0.0, check=False).record
    else:
        record = train.program_steps(c, cfg, 2 ** 33 + 5, 0.2, True, "cpu", 0.0)[1]
    for name in CELLS[cell]:
        v = _read(name, record)
        assert v is not None and 0.0 <= v <= 100.0, (name, v)
