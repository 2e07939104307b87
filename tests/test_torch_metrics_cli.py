"""The port's ``metrics`` verb held against the JAX package's.

Each package writes one run stream in this process: a manifest, spans,
an instrumented call at two signatures (one retrace), a device sync,
serve counters, ``front_request`` and ``probe_request`` events and a
``micro_batch``.  Every ``metrics`` subcommand of both CLIs then reads
the JAX-written and the port-written stream: the same stdout and exit
code, ``roofline`` under the same ``--peaks`` and under the stream's own
backend.  ``scale-check`` (ROADMAP item 10) exits 2 in the port.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.telemetry import dispatch as jdispatch
from spark_text_clustering_tpu.telemetry import roofline as jroofline
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import telemetry as ttelemetry
from spark_text_clustering_tpu_torch.telemetry import dispatch as tdispatch
from spark_text_clustering_tpu_torch.telemetry import roofline as troofline


def _write(tel, path, f, arrays):
    tel.configure(path)
    tel.manifest(kind="serve")
    with tel.span("phase.train"):
        g = tel.instrument_dispatch("em.packed_chunk", f)
        for x in arrays:
            out = g(x)
        tel.device_sync(out, "em_packed")
    tel.count("serve.requests", 6)
    tel.count("serve.batches", 2)
    for i in range(6):
        tel.observe("serve.request_seconds", 0.01 * (i + 1))
        tel.event("front_request", outcome="ok" if i % 3 else "error",
                  seconds=0.02 * i, priority="interactive", replica=i % 2)
        tel.event("probe_request", outcome="ok", seconds=0.01,
                  priority="batch")
    tel.event("micro_batch", batch_id=0, docs=3, seconds=0.1)
    tel.shutdown()


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{"jax": path, "port": path}: one stream written by each package."""
    import jax
    import jax.numpy as jnp

    root = tmp_path_factory.mktemp("metrics_streams")
    paths = {"jax": str(root / "jax.jsonl"), "port": str(root / "port.jsonl")}
    jdispatch.reset()
    tdispatch.reset()
    _write(jtelemetry, paths["jax"], jax.jit(lambda x: x * 2.0),
           [jnp.ones(4), jnp.ones(8), jnp.ones(4)])
    _write(ttelemetry, paths["port"], lambda x: x * 2.0,
           [torch.ones(4), torch.ones(8), torch.ones(4)])
    jdispatch.reset()
    tdispatch.reset()
    return paths


def _jax(argv):
    args = jcli.build_parser().parse_args(["metrics", *argv])
    return args.fn(args)


def _port(argv):
    return tcli.main(["metrics", *argv])


def both(argv):
    """(rc, stdout) of each package's ``metrics <argv>``."""
    out = {}
    for name, main in (("jax", _jax), ("port", _port)):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(argv)
        out[name] = (rc, buf.getvalue())
    return out["jax"], out["port"]


SINGLE = [
    ["summarize", "{s}"],
    ["summarize", "{s}", "--json"],
    ["tail", "{s}", "--once"],
    ["trace", "{s}"],
    ["trace", "{s}", "--causal"],
    ["merge", "{s}", "{s}", "--json"],
    ["merge", "{s}", "{s}"],
    ["slo", "{s}"],
    ["slo", "{s}", "--json", "--fail-on-burn"],
    ["roofline", "{s}"],
    ["roofline", "{s}", "--json"],
    ["roofline", "{s}", "--json", "--peaks", "{peaks}"],
    ["compile-check", "{s}", "--baseline", "{base}"],
]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("argv", SINGLE, ids=[" ".join(a) for a in SINGLE])
def test_each_subcommand_reads_a_stream_as_jax_does(streams, tmp_path,
                                                    writer, argv):
    peaks = tmp_path / "peaks.json"
    peaks.write_text(json.dumps({"flops_per_s": 1e9, "bytes_per_s": 1e8}))
    base = tmp_path / "compile.json"
    base.write_text(json.dumps({"labels": {"em.packed_chunk": 1}}))
    argv = [a.format(s=streams[writer], peaks=peaks, base=base)
            for a in argv]
    j, t = both(argv)
    assert t == j
    assert j[1]


@pytest.mark.parametrize("cmd", ["diff", "bench-diff"])
def test_two_stream_subcommands_as_jax_does(streams, cmd):
    j, t = both([cmd, streams["jax"], streams["port"]])
    assert t == j and j[1]


def test_baseline_writers_as_jax_does(streams, tmp_path):
    """``check`` and ``compile-check`` capture a baseline and check
    against it: the same files, output and exit codes."""
    for cmd, extra in (("check", []), ("compile-check", [])):
        outs = {}
        base = tmp_path / f"{cmd}.json"
        for name, main in (("jax", _jax), ("port", _port)):
            base.unlink(missing_ok=True)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rcs = [main([cmd, streams["port"], "--baseline", str(base),
                             "--write-baseline", *extra]),
                       main([cmd, streams["jax"], "--baseline", str(base)])]
            with open(base) as f:
                outs[name] = (rcs, buf.getvalue(), json.load(f))
        assert outs["port"] == outs["jax"]


def test_the_retrace_reaches_compile_check(streams):
    """The instrumented call's second signature is a retrace to both
    sentinels (so the one-signature baseline of ``SINGLE``'s
    ``compile-check`` fails in both)."""
    for path in streams.values():
        snap = [json.loads(x) for x in open(path)][-1]["snapshot"]
        assert snap["counters"]["compile.retraces"] == 1
        assert snap["gauges"]["compile.em.packed_chunk.signatures"] == 2


def test_resolve_peaks_names_the_h100():
    row = {"flops_per_s": 67e12, "bytes_per_s": 3.35e12,
           "hbm_bytes": 80 * 2**30}
    for args in (("nvidia-h100",), ("gpu",),
                 ("gpu", "NVIDIA H100 80GB HBM3")):
        key, peaks = troofline.resolve_peaks(*args)
        assert key == "nvidia-h100"
        assert {k: peaks[k] for k in row} == row
    # every row JAX has, the port has as it is
    for key, peaks in jroofline.BACKEND_PEAKS.items():
        assert troofline.BACKEND_PEAKS[key] == peaks
    assert troofline.resolve_peaks("cpu") == jroofline.resolve_peaks("cpu")
    assert troofline.live_peaks("cpu")[0] == "cpu"


def test_scale_check_is_item_10(capsys):
    assert _port(["scale-check", "--run"]) == 2
    assert "item 10" in capsys.readouterr().err


def test_roofline_of_a_card_stream_reads_the_h100_row(tmp_path):
    """A port stream from the card (``backend`` "gpu"), one call of two
    kernel launches: the port's ``roofline`` joins its row on the H100's
    peaks."""
    path = str(tmp_path / "card.jsonl")
    est_bytes, est_flops, seconds = 3.35e9, 6.7e9, 2e-3
    lines = [
        {"event": "manifest", "schema": 1, "kind": "train", "backend": "gpu",
         "device_kind": "NVIDIA H100 80GB HBM3", "ts": 1.0},
        {"event": "dispatch_executable", "digest": "0123456789",
         "label": "em.packed_chunk", "est_bytes": est_bytes,
         "est_flops": est_flops, "cost_source": "kernels",
         "compile_seconds": None, "ts": 2.0},
        {"event": "registry", "ts": 3.0, "snapshot": {
            "counters": {"dispatch.0123456789.calls": 1,
                         "dispatch.0123456789.launches.em_sweep_fused": 2},
            "gauges": {"dispatch.0123456789.wall_seconds_total": seconds},
            "histograms": {}}},
    ]
    with open(path, "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _port(["roofline", path, "--json"]) == 0
    doc = json.loads(buf.getvalue())
    (row,) = doc["rows"]
    assert doc["peaks_key"] == "nvidia-h100" and row["available"]
    # 1e-3 s of bytes and 1e-4 s of flops at peak, in 2e-3 s: half
    np.testing.assert_allclose(row["roofline_frac"], 0.5)
    assert row["bound"] == "memory"
