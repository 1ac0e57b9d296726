"""The port's metric families (tendermint_tpu_torch/libs/metrics.py)
held against the JAX package's (tendermint_tpu/libs/metrics.py).

The same operations, from a numpy seed, on a fresh Registry of each
package render the same Prometheus exposition text and the same
snapshot()/delta(); the declared catalogs (every family's names,
kinds, help texts) are equal, so one scrape config reads both. The
reference's tests/test_metrics.py cases that are not about its chip
run on both packages (parametrised); its lint-and-docs case is left
out (its tools are not ported)."""

from __future__ import annotations

import re
import threading

import numpy as np
import pytest

from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.libs import metrics as pmetrics
from tendermint_tpu_torch.libs import tracing as ptracing

PACKAGES = {"port": (pmetrics, ptracing), "reference": (jmetrics, jtracing)}


def _seeded_ops(seed: int, n: int = 200) -> list[tuple]:
    """(metric index, op, value, label value) from a numpy seed."""
    rng = np.random.default_rng(seed)
    labels = (None, "a", "b", 'q"uo\\te', "line\nbreak")
    return [(int(rng.integers(4)), int(rng.integers(3)),
             float(np.round(rng.exponential(0.3), 6)),
             labels[rng.integers(len(labels))]) for _ in range(n)]


def _registry(M, ops):
    reg = M.Registry()
    ms = [reg.counter("ops_total", "Ops\nseen.", "test"),
          reg.gauge("depth", "Depth \\ fill.", "test"),
          reg.histogram("lat", "Latency.", "test"),
          reg.histogram("lanes", "Lanes.", "test",
                        buckets=(1, 8, 64, 512, 4096))]
    for idx, op, value, label in ops:
        kw = {} if label is None else {"peer": label}
        m = ms[idx]
        if isinstance(m, M.Histogram):
            (m.labels(**kw).observe if op == 2 and kw else m.observe)(
                value * (1000 if idx == 3 else 1), **({} if op == 2 and kw
                                                       else kw))
        elif isinstance(m, M.Gauge) and op == 1:
            m.set(value, **kw)
        elif isinstance(m, M.Gauge) and op == 2:
            m.dec(value, **kw)
        else:
            m.inc(value, **kw)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exposition_text_equal_on_the_same_operations(seed):
    ops = _seeded_ops(seed)
    texts = {k: _registry(M, ops).render_text()
             for k, (M, _) in PACKAGES.items()}
    assert texts["port"] == texts["reference"]
    assert "# TYPE test_lat histogram" in texts["port"]
    assert 'test_lat_bucket{le="+Inf"}' in texts["port"]


@pytest.mark.parametrize("seed", [4, 5])
def test_snapshot_and_delta_equal_on_the_same_operations(seed):
    ops = _seeded_ops(seed)
    got = {}
    for k, (M, _) in PACKAGES.items():
        reg = _registry(M, ops[:100])
        before = M.snapshot(reg)
        reg2 = _registry(M, ops)
        got[k] = (before, M.delta(before, M.snapshot(reg2)))
    assert got["port"] == got["reference"]
    assert got["port"][1]


def test_the_catalogs_are_equal():
    """Every family of the reference under the same metric names, kinds,
    help texts and buckets (subsystem `tpu` included)."""
    def catalog(M):
        return {name: (m.kind, m.help, getattr(m, "buckets", None))
                for name, m in M.all_module_metrics().items()}

    p, j = catalog(pmetrics), catalog(jmetrics)
    assert p == j
    assert "tpu_launch_ledger_records_total" in p
    assert "tpu_effective_backend" in p and len(p) > 100


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_counter_gauge_histogram_render(pkg):
    M = PACKAGES[pkg][0]
    reg = M.Registry()
    c = reg.counter("reqs_total", "Requests.", "test")
    c.inc()
    c.inc(2, code="200")
    reg.gauge("height", "Height.", "test").set(42)
    h = reg.histogram("lat", "Latency.", "test", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render_text()
    assert "# TYPE test_reqs_total counter" in text
    assert 'test_reqs_total{code="200"} 2' in text
    assert "test_height 42" in text
    assert 'test_lat_bucket{le="0.1"} 1' in text
    assert 'test_lat_bucket{le="+Inf"} 3' in text
    assert "test_lat_count 3" in text


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_histogram_timer(pkg):
    M = PACKAGES[pkg][0]
    h = M.Registry().histogram("t", "T.", "x")
    with h.time():
        pass
    assert h.count == 1 and h.sum >= 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_label_value_escaping(pkg):
    M = PACKAGES[pkg][0]
    reg = M.Registry()
    reg.counter("conns_total", "Conns.", "test").inc(
        1, addr='tcp://10.0.0.1:26656/"quoted"\\path\nline2')
    assert ('test_conns_total{addr="tcp://10.0.0.1:26656/'
            '\\"quoted\\"\\\\path\\nline2"} 1') in reg.render_text()
    h = reg.counter("x_total", "line1\nline2\\tail", "test")
    assert "# HELP test_x_total line1\\nline2\\\\tail" in h.render()[0]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_labelled_histogram_render_and_cumulative_buckets(pkg):
    M = PACKAGES[pkg][0]
    reg = M.Registry()
    h = reg.histogram("lat", "Latency.", "test", buckets=(0.1, 1.0))
    h.observe(0.05, conn="consensus")
    h.observe(0.5, conn="consensus")
    h.observe(5.0, conn="query")
    h.labels(conn="consensus").observe(0.07)
    text = reg.render_text()
    assert 'test_lat_bucket{conn="consensus",le="0.1"} 2' in text
    assert 'test_lat_bucket{conn="consensus",le="+Inf"} 3' in text
    assert 'test_lat_bucket{conn="query",le="+Inf"} 1' in text
    assert h.count == 4
    out = "\n".join(reg.histogram("idle", "I.", "test",
                                  buckets=(1.0,)).render())
    assert 'test_idle_bucket{le="+Inf"} 0' in out


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_histogram_concurrent_observe_render_consistent(pkg):
    M = PACKAGES[pkg][0]
    reg = M.Registry()
    h = reg.histogram("t", "T.", "x", buckets=(0.5,))
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            h.observe(0.1)
            h.observe(0.9)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(100):
            text = reg.render_text()
            buckets = [int(m) for m in re.findall(
                r'x_t_bucket{le="[^"]+"} (\d+)', text)]
            count = int(re.search(r"x_t_count (\d+)", text).group(1))
            assert buckets == sorted(buckets) and buckets[-1] == count
    finally:
        stop.set()
        for t in threads:
            t.join()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_tracing_metrics_bridge(pkg):
    """A span close on the global TRACER feeds the kind's histogram:
    the tpu stage histograms for the device pipeline, the generic
    tracing_span_seconds{kind} for the rest; a private tracer feeds
    nothing."""
    M, tr = PACKAGES[pkg]
    tm = M.tpu_metrics()
    before = tm.pack_seconds.count
    with tr.TRACER.span(tr.CRYPTO_PACK, lanes=4):
        pass
    assert tm.pack_seconds.count == before + 1
    hist = M.tracing_metrics().span_seconds
    before = hist.count
    with tr.TRACER.span(tr.WAL_FSYNC):
        pass
    assert hist.count == before + 1
    assert 'tracing_span_seconds_bucket{kind="wal.fsync",le="+Inf"}' in \
        M.DEFAULT.render_text()
    before = tm.pack_seconds.count
    with tr.Tracer(capacity=8).span(tr.CRYPTO_PACK, lanes=1):
        pass
    assert tm.pack_seconds.count == before


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_metrics_snapshot_delta(pkg):
    M = PACKAGES[pkg][0]
    reg = M.Registry()
    c = reg.counter("ops_total", "Ops.", "test")
    h = reg.histogram("lat", "Lat.", "test", buckets=(0.1, 1.0, 10.0))
    c.inc(3, kind="a")
    h.observe(0.05)
    before = M.snapshot(reg)
    c.inc(2, kind="a")
    c.inc(1, kind="b")
    h.observe(0.5)
    h.observe(0.6)
    d = M.delta(before, M.snapshot(reg))
    assert d['test_ops_total{kind="a"}'] == 2
    assert d['test_ops_total{kind="b"}'] == 1
    assert d["test_lat"]["count"] == 2
    assert abs(d["test_lat"]["sum"] - 1.1) < 1e-6
    assert 0.1 <= d["test_lat"]["p50"] <= 1.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_node_metrics_provider_gating(pkg):
    import importlib

    M = PACKAGES[pkg][0]
    cfg = importlib.import_module(M.__name__.rsplit(".", 2)[0] + ".config")
    on = M.metrics_provider(cfg.InstrumentationConfig(prometheus=True))
    off = M.metrics_provider(cfg.InstrumentationConfig(prometheus=False))
    assert isinstance(on("chain-a"), M.NodeMetrics)
    assert off("chain-a") is None


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_reference_catalog_metrics_present(pkg):
    M = PACKAGES[pkg][0]
    M.node_metrics()
    text = M.DEFAULT.render_text()
    for want in ("consensus_height", "consensus_validators_power",
                 "consensus_block_interval_seconds",
                 "consensus_fast_syncing", "consensus_state_syncing",
                 "p2p_peers", "p2p_pending_send_bytes", "mempool_size",
                 "mempool_recheck_times", "state_block_processing_seconds",
                 "tpu_hbm_resident_bytes", "tpu_device_exec_seconds"):
        assert want in text


def test_a_launch_moves_the_ledger_counter_under_the_gpu_label():
    """Label values that name a backend come from the port's vocabulary:
    a record on "cuda:0" counts under backend="gpu"."""
    from tendermint_tpu_torch.crypto.cuda import ledger

    c = pmetrics.tpu_metrics().launch_ledger_records
    before = c.value(workload="bench", backend="gpu")
    with ledger.workload("bench"):
        ledger.record(device="cuda:0", verdict="ok")
    assert c.value(workload="bench", backend="gpu") == before + 1
    ledger.reset()
