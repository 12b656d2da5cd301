"""The port's Prometheus exposition and span tracer (obs/prom.py,
obs/trace.py) against tpu_dpow's.

The same seeded registry operations run on a fresh registry of each
package: the rendered pages must be byte-identical, each package's parser
must read the other's page to the same samples, and histogram quantiles
must agree (tolerance: exact). The tracer keeps the span names and the
``dpow_request_stage_seconds`` family.
"""

import asyncio

import aiohttp
import numpy as np
import pytest

from tpu_dpow import obs as jobs
from tpu_dpow.obs import prom as jprom
from tpu_dpow.obs import trace as jtrace
from tpu_dpow.obs.registry import Registry as JaxRegistry
from tpu_dpow_torch import obs as tobs
from tpu_dpow_torch.obs import prom as tprom
from tpu_dpow_torch.obs import trace as ttrace
from tpu_dpow_torch.obs.registry import Registry as TorchRegistry


def scripted_ops(reg, seed: int) -> None:
    """A seeded mix of every family kind, labels (with characters the text
    format escapes), and values from tiny to huge."""
    rng = np.random.default_rng(seed)
    c = reg.counter("dpow_t_events_total", 'Events "quoted"\nand a newline', ("kind",))
    g = reg.gauge("dpow_t_level", "A level \\ with a backslash")
    h = reg.histogram("dpow_t_seconds", "Latency", ("stage",))
    hb = reg.histogram("dpow_t_rows", "Rows", buckets=(1, 4, 16, 64))
    for _ in range(64):
        c.inc(int(rng.integers(1, 5)), ["a", 'b"q', "c\\d", "e\nf"][int(rng.integers(0, 4))])
        g.set(float(rng.normal()) * 10 ** int(rng.integers(-3, 17)))
        h.observe(float(rng.exponential(0.01)), ["pack", "device", "result"][int(rng.integers(0, 3))])
        hb.observe(int(rng.integers(0, 100)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rendered_pages_byte_identical(seed):
    treg, jreg = TorchRegistry(), JaxRegistry()
    scripted_ops(treg, seed)
    scripted_ops(jreg, seed)
    page = tprom.render(treg)
    assert page.encode() == jprom.render(jreg).encode()
    assert tprom.parse_text(page) == jprom.parse_text(page)
    jpage = jprom.render(jreg)
    assert tprom.parse_text(jpage) == jprom.parse_text(jpage)


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_histogram_quantiles_agree(q):
    treg, jreg = TorchRegistry(), JaxRegistry()
    scripted_ops(treg, 7)
    scripted_ops(jreg, 7)
    for name, labels in (("dpow_t_seconds", {"stage": "pack"}), ("dpow_t_rows", {})):

        def rows(prom, reg):
            samples = prom.parse_text(prom.render(reg))[name + "_bucket"]
            return [(float(lb["le"]), v) for lb, v in samples
                    if {k: x for k, x in lb.items() if k != "le"} == labels]

        got = tprom.histogram_quantile(rows(tprom, treg), q)
        want = jprom.histogram_quantile(rows(jprom, jreg), q)
        assert got == want and got is not None


def test_empty_registry_renders_alike():
    assert tprom.render(TorchRegistry()) == jprom.render(JaxRegistry())


def test_tracer_spans_and_stage_family():
    assert ttrace.STAGES == jtrace.STAGES
    assert ttrace.STAGE_HISTOGRAM == jtrace.STAGE_HISTOGRAM
    assert ttrace.is_trace_id(ttrace.new_trace_id())
    for bad in ("", "0123456789ABCDEF", "0123456789abcde", "zz" * 8):
        assert ttrace.is_trace_id(bad) == jtrace.is_trace_id(bad) is False
    reg = TorchRegistry()
    tr = ttrace.Tracer(reg)
    tid = tr.begin("HASH", stage="dispatch")
    tr.mark_hash("HASH", "pack")
    tr.mark_hash("HASH", "device")
    tr.mark(tid, "result")
    assert [s for s, _ in tr.spans(tid)] == ["dispatch", "pack", "device", "result"]
    assert tr.id_for("HASH") == tid
    series = reg.snapshot()[ttrace.STAGE_HISTOGRAM]["series"]
    counts = {k: v["count"] for k, v in series.items()}
    assert counts == {"pack": 1, "device": 1, "result": 1}
    tr.alias("OTHER", "f" * 16)
    tr.mark_hash("OTHER", "pack")  # an id off the wire: no earlier mark, no sample
    tr.mark(None, "pack")  # never raises
    tr.reset()
    assert tr.get(tid) == []


def test_port_reset_clears_series_and_traces_without_touching_jax():
    jobs.reset()
    jobs.get_registry().counter("dpow_t_jax_only_total", "x").inc()
    tobs.get_registry().counter("dpow_t_port_only_total", "x").inc()
    tid = tobs.get_tracer().begin("K")
    tobs.reset()
    assert tobs.get_tracer().get(tid) == []
    assert "dpow_t_jax_only_total" in jobs.snapshot()
    assert "dpow_t_jax_only_total" not in tobs.render()
    jobs.reset()


def test_metrics_route_serves_the_ports_registry():
    from aiohttp import web

    async def go():
        reg = TorchRegistry()
        reg.counter("dpow_client_t_total", "x").inc(3)
        app = web.Application()
        tobs.add_metrics_route(app, reg)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            async with aiohttp.ClientSession() as http:
                for path in ("/metrics", "/metrics/"):
                    async with http.get(f"http://127.0.0.1:{port}{path}") as resp:
                        assert resp.status == 200
                        text = await resp.text()
                        assert text == tprom.render(reg)
        finally:
            await runner.cleanup()

    asyncio.run(asyncio.wait_for(go(), 20))


def test_engine_marks_pack_and_device_on_the_trace():
    from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend
    from tpu_dpow_torch.models import WorkRequest

    h = np.random.default_rng(71).bytes(32).hex().upper()
    tracer = tobs.get_tracer()

    async def go():
        b = TorchWorkBackend(device="cpu", mesh_devices=2)
        await b.setup()
        tracer.alias(h, "0123456789abcdef")
        tracer.mark_hash(h, "dispatch")
        await b.generate(WorkRequest(h, 0xFFF0000000000000))
        await b.close()

    asyncio.run(asyncio.wait_for(go(), 30))
    stages = [s for s, _ in tracer.spans("0123456789abcdef")]
    assert stages == ["dispatch", "pack", "device"]
