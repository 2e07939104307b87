"""The port's measured-scale observatory (``telemetry.scale_probe`` and
``metrics scale-check``) held against the JAX package's.

One test for each of the JAX package's ``tests/test_scale_probe.py``:

  * the reconciliation math on JAX's planted ``_evidence()`` /
    ``_record()``, the ``measured`` twin section and its drift rules, and
    the ``scale-check`` gate on planted probes, through the port's CLI;
  * the live probe: one module-scoped ``run_probe`` of two entries on a
    spawned 2x2 gloo grid of CPU ranks (JAX runs 8 virtual devices in one
    process): forced sharding, shard shapes read from widths, zero
    retraces, CPU memory rows ``unavailable``, the ranks' streams, and a
    clean reconciliation against the committed record without its
    ``measured`` section (that section is the card's);
  * per-device memory, the roofline HBM column and the Prometheus
    exposition of the ``scale.`` family.

Then the port's own: ``dryrun_grid``, a planted rank given the full
vocabulary (replicated), a 1-rank run, the committed card section, and
parity with the JAX package where its half runs here: ``reconcile``,
``measured_section`` and both CLIs' ``--json`` documents and exit codes
on every planted case, and the constants.  (JAX's live probe fails
under the installed jax, so it is no running reference.)
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os

import pytest
import torch

from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.telemetry import dispatch as jdispatch
from spark_text_clustering_tpu.telemetry import scale_probe as jsp
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.analysis.scale_audit import (
    DEFAULT_SCALE_BASELINE_PATH,
    compare_measured_with_record,
    load_scale_record,
    save_scale_record,
)
from spark_text_clustering_tpu_torch.cli import main
from spark_text_clustering_tpu_torch.parallel.mesh import (
    DRYRUN_RANKS,
    ProcessGrid,
    dryrun_grid,
)
from spark_text_clustering_tpu_torch.telemetry import dispatch as dispatch_attr
from spark_text_clustering_tpu_torch.telemetry import memory as mem
from spark_text_clustering_tpu_torch.telemetry import scale_probe as tsp
from spark_text_clustering_tpu_torch.telemetry.metrics_cli import (
    load_run,
    memory_health,
    run_metrics,
)
from spark_text_clustering_tpu_torch.telemetry.prometheus import render
from spark_text_clustering_tpu_torch.telemetry.roofline import (
    resolve_peaks,
    roofline_row,
)
from spark_text_clustering_tpu_torch.telemetry.scale_probe import (
    PROBE_DIMS,
    measured_section,
    probe_spec_names,
    reconcile,
    run_probe,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE_RECORD = os.path.join(REPO_ROOT, DEFAULT_SCALE_BASELINE_PATH)
LIVE_ENTRIES = ["em_lda.bucket_step", "sharded_eval.em_log_likelihood"]


def _reset():
    telemetry.shutdown()
    telemetry.get_registry().reset()
    dispatch_attr.reset()
    jtelemetry.shutdown()
    jtelemetry.get_registry().reset()
    jdispatch.reset()


@pytest.fixture(autouse=True)
def _telemetry_reset():
    _reset()
    yield
    _reset()


def _card_free_record(tmp_path):
    """A copy of the committed record without its ``measured`` section:
    that section is the card's, and a CPU probe's ratios (another
    ``mem_source``) are not comparable with it."""
    record = load_scale_record(SCALE_RECORD)
    record.pop("measured", None)
    path = tmp_path / "scale_baseline.json"
    path.write_text(json.dumps(record))
    return str(path)


# ---------------------------------------------------------------------------
# synthetic fixtures for the pure reconciliation units (JAX's)
# ---------------------------------------------------------------------------
def _evidence():
    return {
        "version": 1,
        "backend": "cpu",
        "device_kind": "cpu",
        "device_count": 8,
        "mesh": {"data_shards": 2, "model_shards": 4},
        "forced_model_sharding": True,
        "geometry": dict(PROBE_DIMS),
        "warm_steps": 2,
        "entries": {
            "em_lda.bucket_step": {
                "label": "scale_probe.em_bucket_step",
                "digests": ["d1"],
                "expects_sharding": True,
                "measured": {
                    "per_chip_peak_bytes": 2_000_000,
                    "mem_source": "memory_analysis",
                    "collective_bytes_per_step": 500_000,
                    "first_call_seconds": 0.2,
                    "warm_step_seconds": [0.01, 0.01],
                },
                "predicted": {
                    "per_chip_peak_bytes": 2_100_000,
                    "collective_bytes_per_step": 520_000,
                },
                "model_sharded": True,
                "shardings": [],
                "retraces_after_first": 0,
            },
        },
        "device_memory": {"devices": 8, "reporting": 0,
                          "per_device": []},
        "roofline": [],
    }


def _record():
    return {
        "entries": {
            "em_lda.bucket_step": {
                "per_chip_peak_bytes": 5_531_529_978,
                "hbm_budget_bytes": 15_461_882_265,
                "collective_bytes_per_step": 1_774_290_000,
                "model_shards": 16,
            },
        },
    }


def _em(ev):
    return ev["entries"]["em_lda.bucket_step"]


class TestReconcileMath:
    def test_relative_error_and_extrapolation(self):
        recon = reconcile(_evidence(), _record())
        row = recon["entries"]["em_lda.bucket_step"]
        assert row["peak_rel_error"] == pytest.approx(
            (2_000_000 - 2_100_000) / 2_100_000, abs=1e-4)
        assert row["collective_rel_error"] == pytest.approx(
            (500_000 - 520_000) / 520_000, abs=1e-4)
        extra = row["extrapolation"]
        ratio = 2_000_000 / 2_100_000
        assert extra["peak_ratio"] == pytest.approx(ratio, abs=1e-4)
        assert extra["implied_per_chip_bytes"] == pytest.approx(
            5_531_529_978 * ratio, rel=1e-3)
        assert extra["within_budget"] is True
        assert recon["divergences"] == 0
        assert recon["sharding_mismatches"] == 0

    def test_conservative_underprediction_does_not_gate(self):
        ev = _evidence()
        _em(ev)["measured"]["per_chip_peak_bytes"] = 500_000
        assert reconcile(ev, _record())["divergences"] == 0

    def test_measured_over_tolerance_diverges(self):
        ev = _evidence()
        _em(ev)["measured"]["per_chip_peak_bytes"] = int(2_100_000 * 1.3)
        recon = reconcile(ev, _record())
        assert recon["divergences"] == 1
        assert "exceeds the static estimate" in \
            recon["entries"]["em_lda.bucket_step"]["divergences"][0]

    def test_over_budget_extrapolation_diverges(self):
        ev = _evidence()
        _em(ev)["measured"]["per_chip_peak_bytes"] = 2_100_000 * 30
        recon = reconcile(ev, _record())
        row = recon["entries"]["em_lda.bucket_step"]
        assert row["extrapolation"]["within_budget"] is False
        # over tolerance AND over budget: two divergences
        assert recon["divergences"] == 2
        assert any("HBM budget" in d for d in row["divergences"])

    def test_collective_over_tolerance_diverges(self):
        ev = _evidence()
        _em(ev)["measured"]["collective_bytes_per_step"] = int(520_000 * 1.4)
        assert reconcile(ev, _record())["divergences"] == 1

    def test_replicated_run_flags_sharding_mismatch(self):
        ev = _evidence()
        _em(ev)["model_sharded"] = False
        recon = reconcile(ev, _record())
        assert recon["sharding_mismatches"] == 1
        assert any("REPLICATED" in d for d in
                   recon["entries"]["em_lda.bucket_step"]["divergences"])

    def test_retraces_diverge(self):
        ev = _evidence()
        _em(ev)["retraces_after_first"] = 2
        assert reconcile(ev, _record())["divergences"] == 1

    def test_measured_unavailable_degrades_to_note(self):
        ev = _evidence()
        _em(ev)["measured"]["per_chip_peak_bytes"] = None
        _em(ev)["measured"]["mem_source"] = "unavailable:no_record"
        recon = reconcile(ev, _record())
        row = recon["entries"]["em_lda.bucket_step"]
        assert recon["divergences"] == 0
        assert any("unavailable" in n for n in row["notes"])
        assert "extrapolation" not in row

    def test_entry_without_record_row_reconciles_shardings_only(self):
        ev = _evidence()
        recon = reconcile(ev, {"entries": {}})
        row = recon["entries"]["em_lda.bucket_step"]
        assert row["record"] is False
        assert "extrapolation" not in row
        assert recon["divergences"] == 0
        # ... but a replicated run still gates even without a record
        _em(ev)["model_sharded"] = False
        assert reconcile(ev, {"entries": {}})["sharding_mismatches"] == 1

    def test_unforced_mesh_is_a_probe_divergence(self):
        ev = _evidence()
        ev["forced_model_sharding"] = False
        ev["mesh"] = {"data_shards": 1, "model_shards": 1}
        recon = reconcile(ev, _record())
        assert recon["divergences"] >= 1
        assert "did not force model-axis sharding" in \
            recon["probe_divergence"]


class TestMeasuredRecord:
    def test_measured_section_shape(self):
        recon = reconcile(_evidence(), _record())
        sec = measured_section(_evidence(), recon)
        e = sec["entries"]["em_lda.bucket_step"]
        assert e["model_sharded"] is True
        assert e["retraces_after_first"] == 0
        assert 0 < e["peak_ratio"] < 1.01
        assert e["within_budget"] is True
        assert sec["mesh"] == {"data_shards": 2, "model_shards": 4}

    def test_drift_rules(self):
        recon = reconcile(_evidence(), _record())
        sec = measured_section(_evidence(), recon)
        record = dict(_record(), measured=copy.deepcopy(sec))
        assert compare_measured_with_record(sec, record) == []
        moved = copy.deepcopy(sec)
        moved["entries"]["em_lda.bucket_step"]["peak_ratio"] += 0.5
        assert [f["field"] for f in compare_measured_with_record(
            moved, record)] == ["peak_ratio"]
        repl = copy.deepcopy(sec)
        repl["entries"]["em_lda.bucket_step"]["model_sharded"] = False
        assert [f["field"] for f in compare_measured_with_record(
            repl, record)] == ["model_sharded"]
        other = copy.deepcopy(sec)
        other["geometry"] = dict(other["geometry"], v=1234)
        assert [f["field"] for f in compare_measured_with_record(
            other, record)] == ["geometry"]
        assert compare_measured_with_record(sec, _record()) == []

    def test_static_rebaseline_preserves_measured_section(self, tmp_path):
        path = str(tmp_path / "sb.json")
        rec = dict(_record(), measured={"entries": {}, "geometry": {},
                                        "mesh": {}})
        save_scale_record(rec, path)
        save_scale_record(_record(), path)
        assert "measured" in load_scale_record(path)
        rec2 = load_scale_record(path)
        rec2["measured"] = {"entries": {"x": {}}, "geometry": {},
                            "mesh": {}}
        save_scale_record(rec2, path)
        assert load_scale_record(path)["measured"]["entries"] == {"x": {}}


# ---------------------------------------------------------------------------
# the live probe on a spawned 2x2 grid of CPU ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def live_probe(tmp_path_factory):
    """(evidence, the ranks' stream paths): one probe of two entries, each
    rank writing its own stream."""
    _reset()
    root = tmp_path_factory.mktemp("scale_probe")
    evidence = run_probe(entries=LIVE_ENTRIES, device="cpu",
                         telemetry_file=str(root / "probe.jsonl"))
    streams = [str(root / f"probe-p{r}.jsonl") for r in range(DRYRUN_RANKS)]
    return evidence, streams


class TestLiveProbe:
    def test_forces_model_sharding(self, live_probe):
        evidence, _ = live_probe
        assert evidence["device_count"] == 4
        assert evidence["mesh"] == {"data_shards": 2, "model_shards": 2}
        assert evidence["forced_model_sharding"] is True
        assert evidence["backend"] == "cpu"
        assert sorted(evidence["entries"]) == sorted(LIVE_ENTRIES)

    def test_em_bucket_step_measured_sharded(self, live_probe):
        evidence, _ = live_probe
        e = evidence["entries"]["em_lda.bucket_step"]
        assert e["model_sharded"] is True
        v = evidence["geometry"]["v"]
        wide = [r for r in e["shardings"] if r["sharded"]]
        assert wide and len(wide) == len(e["shardings"]), e["shardings"]
        # each rank's lambda in and out: the vocabulary cut two ways
        assert sorted({(r["rank"], r["side"]) for r in wide}) == sorted(
            (r, s) for r in range(4) for s in ("in", "out"))
        for r in wide:
            assert v // 2 in r["shard_shape"]
            assert v in r["shape"]
            assert "model" in r["spec"]

    def test_zero_retraces_and_measured_evidence(self, live_probe):
        evidence, _ = live_probe
        for name, e in evidence["entries"].items():
            assert e["retraces_after_first"] == 0, name
            assert e["measured"]["per_chip_peak_bytes"] > 0, name
            # no allocator on the CPU: the dispatch record's attribution
            assert e["measured"]["mem_source"].startswith("tensors"), name
            assert e["predicted"]["per_chip_peak_bytes"] > 0
            assert e["measured"]["collective_bytes_per_step"] > 0
            assert e["predicted"]["collective_bytes_per_step"] > 0
            assert len(e["measured"]["warm_step_seconds"]) == 2

    def test_memory_stats_absent_degrades(self, live_probe):
        """CPU ranks expose no memory statistics: every row says so, and
        nothing crashes."""
        evidence, _ = live_probe
        dm = evidence["device_memory"]
        assert dm["devices"] == 4
        assert dm["reporting"] == 0
        assert all("unavailable" in r for r in dm["per_device"])
        assert sorted(r["rank"] for r in dm["per_device"]) == [0, 1, 2, 3]

    def test_roofline_rows_and_counter(self, live_probe):
        evidence, streams = live_probe
        digests = {d for e in evidence["entries"].values()
                   for d in e["digests"]}
        assert {r["digest"] for r in evidence["roofline"]} == digests
        for path in streams:
            manifest, events = load_run(path)
            assert manifest["kind"] == "scale_probe"
            assert run_metrics(events)["counter.scale.probe_runs"] == 1
            announced = {e["digest"] for e in events
                         if e.get("event") == "dispatch_executable"}
            assert announced == digests, path
            probed = [e["name"] for e in events
                      if e.get("event") == "scale_probe_entry"]
            assert sorted(probed) == sorted(LIVE_ENTRIES)
            assert any(e.get("event") == "memory_sample" for e in events)

    def test_reconciles_against_committed_record(self, live_probe,
                                                 tmp_path):
        evidence, _ = live_probe
        record = load_scale_record(_card_free_record(tmp_path))
        recon = reconcile(evidence, record)
        assert recon["divergences"] == 0, json.dumps(
            recon["entries"], indent=2, default=str)
        assert recon["sharding_mismatches"] == 0
        extra = recon["entries"]["em_lda.bucket_step"]["extrapolation"]
        assert extra["within_budget"] is True
        # the measured anchor keeps the V=10M claim in the range the
        # static audit committed (~6.6 GiB a card against 72 GiB)
        assert 2 * 2**30 < extra["implied_per_chip_bytes"] < 10 * 2**30


def test_scale_check_runs_the_probe_on_cpu_ranks(tmp_path, capsys):
    """``metrics scale-check --run --device cpu``: a 2x2 gloo grid of CPU
    ranks, its table and a PASS line against the record without its
    card section."""
    rc = main(["metrics", "scale-check", "--run", "--device", "cpu",
               "--entries", "em_lda.bucket_step",
               "--baseline", _card_free_record(tmp_path),
               "--probe-out", str(tmp_path / "probe.json"),
               "--fail-on-divergence"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "probe: backend=cpu mesh=2x2 (data x model) devices=4" in out
    assert "PASS: 1 probed entr(ies), 0 divergence(s)" in out
    evidence = json.loads((tmp_path / "probe.json").read_text())
    assert list(evidence["entries"]) == ["em_lda.bucket_step"]


@pytest.mark.parametrize("ranks,model_shards,shape", [
    (4, None, (2, 2)),
    (8, None, (2, 4)),
    (16, None, (4, 4)),
    (6, None, (3, 2)),
    (2, None, (1, 2)),
    (1, None, (1, 1)),
    (3, None, (3, 1)),
    (4, 4, (1, 4)),
    (4, 3, ValueError),
    (4, 0, ValueError),
])
def test_dryrun_grid(ranks, model_shards, shape):
    """JAX's ``dryrun_mesh`` rule over ranks (the default four ranks give
    2x2, JAX's eight virtual devices 2x4)."""
    if shape is ValueError:
        with pytest.raises(ValueError):
            dryrun_grid(model_shards, ranks)
    else:
        assert dryrun_grid(model_shards, ranks) == shape
    assert dryrun_grid() == (2, 2)


def test_the_probe_defaults_to_the_card(tmp_path):
    """Without a card and without ``--device cpu`` the probe and the verb
    raise, as every entry point of the port does, before a rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_probe()
    out = tmp_path / "probe.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["metrics", "scale-check", "--run", "--probe-out", str(out)])
    assert not out.exists()


def test_bad_geometry_and_unknown_entries_raise():
    """Refused before a rank is spawned, with JAX's messages."""
    with pytest.raises(ValueError, match="does not divide the 2x2"):
        run_probe(dims={"v": 65537}, device="cpu")
    with pytest.raises(ValueError, match="unknown probe entries"):
        run_probe(entries=["nope"], device="cpu")


def _replicated_topic_inference(grid, dims, make):
    """A planted builder that hands its rank the whole vocabulary."""
    fn, args = tsp._build_sharded_topic_inference(grid, dims, make)
    lam = tsp._probe_arrays(dims)[0]
    return fn, (make(lam, torch.float32), *args[1:])


def test_planted_full_vocabulary_runs_replicated():
    """A rank given the full V on a grid of two model shards: its wide
    leaf reads replicated, the entry is not model-sharded, and
    reconciliation counts one sharding mismatch."""
    spec = tsp.ProbeSpec("sharded_eval.topic_inference",
                         _replicated_topic_inference,
                         label="sharded_eval.topic_inference")
    grid = ProcessGrid(1, 2, rank=0, device=torch.device("cpu"))
    telemetry.configure(None, device="cpu")
    predicted = tsp._predict(spec, PROBE_DIMS, 2)
    entry = tsp._probe_entry(spec, grid, dict(PROBE_DIMS), 1, predicted)
    assert entry["model_sharded"] is False
    [row] = [r for r in entry["shardings"] if r["side"] == "in"]
    assert row["spec"] == "replicated" and row["sharded"] is False
    assert row["shard_shape"] == [PROBE_DIMS["k"], PROBE_DIMS["v"]]
    evidence = {
        "forced_model_sharding": True,
        "mesh": {"data_shards": 1, "model_shards": 2},
        "entries": {spec.name: tsp._merge_entry(spec, [entry], predicted)},
    }
    recon = reconcile(evidence, load_scale_record(SCALE_RECORD))
    assert recon["sharding_mismatches"] == 1
    assert any("REPLICATED" in d
               for d in recon["entries"][spec.name]["divergences"])


def test_one_rank_is_a_probe_divergence(tmp_path):
    """One rank gives a 1x1 grid: nothing is cut, and reconciliation
    says sharding was not forced."""
    evidence = run_probe(entries=["sharded_eval.em_log_likelihood"],
                         device="cpu", ranks=1)
    assert evidence["mesh"] == {"data_shards": 1, "model_shards": 1}
    assert evidence["forced_model_sharding"] is False
    recon = reconcile(evidence,
                      load_scale_record(_card_free_record(tmp_path)))
    assert "did not force model-axis sharding" in recon["probe_divergence"]
    assert recon["sharding_mismatches"] == 1


def test_committed_measured_section_is_the_cards():
    """The record's ``measured`` section, taken on the card by
    ``metrics scale-check --run --write-record``: the 2x2 grid at the
    probe geometry, all five entries sharded without a retrace."""
    sec = load_scale_record(SCALE_RECORD)["measured"]
    assert sec["backend"] == "cuda"
    assert "H100" in sec["device_kind"]
    assert sec["mesh"] == {"data_shards": 2, "model_shards": 2}
    assert sec["geometry"] == PROBE_DIMS
    assert sorted(sec["entries"]) == sorted(probe_spec_names())
    for name, e in sec["entries"].items():
        assert e["model_sharded"] is True, name
        assert e["retraces_after_first"] == 0, name
        assert e.get("within_budget", True) is True, name


# ---------------------------------------------------------------------------
# the scale-check CLI (gate semantics)
# ---------------------------------------------------------------------------
def _write_probe(tmp_path, evidence, name="probe.json"):
    p = tmp_path / name
    p.write_text(json.dumps(evidence))
    return str(p)


def _write_record(tmp_path, record=None):
    rec = tmp_path / "sb.json"
    rec.write_text(json.dumps(_record() if record is None else record))
    return str(rec)


class TestScaleCheckCli:
    def test_clean_probe_passes(self, tmp_path, capsys):
        rc = main(["metrics", "scale-check", _write_probe(tmp_path,
                   _evidence()), "--baseline", _write_record(tmp_path),
                   "--fail-on-divergence"])
        assert rc == 0
        assert "PASS:" in capsys.readouterr().out

    def test_planted_over_budget_gates_red(self, tmp_path, capsys):
        ev = _evidence()
        _em(ev)["measured"]["per_chip_peak_bytes"] = 2_100_000 * 30
        rc = main(["metrics", "scale-check", _write_probe(tmp_path, ev),
                   "--baseline", _write_record(tmp_path),
                   "--fail-on-divergence"])
        assert rc == 1
        assert "HBM budget" in capsys.readouterr().out

    def test_planted_replication_gates_red(self, tmp_path, capsys):
        ev = _evidence()
        _em(ev)["model_sharded"] = False
        rc = main(["metrics", "scale-check", _write_probe(tmp_path, ev),
                   "--baseline", _write_record(tmp_path),
                   "--fail-on-divergence"])
        assert rc == 1
        assert "REPLICATED" in capsys.readouterr().out

    def test_no_gate_flag_reports_but_passes_rc(self, tmp_path, capsys):
        ev = _evidence()
        _em(ev)["model_sharded"] = False
        rc = main(["metrics", "scale-check", _write_probe(tmp_path, ev),
                   "--baseline", _write_record(tmp_path)])
        assert rc == 0
        assert "FAIL:" in capsys.readouterr().out

    def test_telemetry_stream_carries_scale_counters(self, tmp_path,
                                                     capsys):
        ev = _evidence()
        _em(ev)["model_sharded"] = False
        stream = tmp_path / "check.jsonl"
        main(["metrics", "scale-check", _write_probe(tmp_path, ev),
              "--baseline", _write_record(tmp_path),
              "--telemetry-file", str(stream)])
        capsys.readouterr()
        _, events = load_run(str(stream))
        metrics = run_metrics(events)
        assert metrics["counter.scale.probe_runs"] == 0
        assert metrics["counter.scale.divergences"] >= 1
        assert metrics["counter.scale.sharding_mismatches"] == 1
        assert any(e.get("event") == "scale_check" for e in events)

    def test_write_record_then_drift_gates(self, tmp_path, capsys):
        probe = _write_probe(tmp_path, _evidence())
        rec = _write_record(tmp_path)
        assert main(["metrics", "scale-check", probe, "--baseline", rec,
                     "--write-record"]) == 0
        capsys.readouterr()
        with open(rec) as f:
            assert "measured" in json.load(f)
        assert main(["metrics", "scale-check", probe, "--baseline", rec,
                     "--fail-on-divergence"]) == 0
        capsys.readouterr()
        # +24% is inside the tolerance but ~0.29 above the committed
        # ratio: the DRIFT rule, not the tolerance, gates it
        ev = _evidence()
        _em(ev)["measured"]["per_chip_peak_bytes"] = int(2_100_000 * 1.24)
        moved = _write_probe(tmp_path, ev, "probe2.json")
        rc = main(["metrics", "scale-check", moved, "--baseline", rec,
                   "--fail-on-divergence"])
        assert rc == 1
        assert "RECORD DRIFT" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# satellites: per-device memory, roofline HBM column, prometheus
# ---------------------------------------------------------------------------
class TestPerDeviceMemory:
    def test_per_device_rows_on_cpu(self):
        rows = mem.per_device_stats("cpu")
        assert rows == [{"device": 0, "kind": "cpu",
                         "unavailable": "no_memory_stats"}]
        assert mem.device_stats(rows) is None
        # no device configured: no rows, and no summed view
        assert mem.per_device_stats() is None
        assert mem.device_stats() is None

    def test_breakdown_math(self):
        rows = [
            {"device": 0, "kind": "gpu", "bytes_in_use": 100,
             "peak_bytes_in_use": 400, "bytes_limit": 1000},
            {"device": 1, "kind": "gpu", "bytes_in_use": 300,
             "peak_bytes_in_use": 100, "bytes_limit": 1000},
            {"device": 2, "kind": "gpu", "unavailable": "x"},
        ]
        br = mem.device_breakdown(rows)
        assert br["reporting_devices"] == 2
        assert br["peak_bytes_in_use_max"] == 400
        assert br["peak_bytes_in_use_min"] == 100
        assert br["bytes_in_use_max"] == 300
        assert br["imbalance"] == pytest.approx(0.75)
        assert mem.device_breakdown(None) is None
        assert mem.device_breakdown([{"device": 0, "unavailable": "x"}]) \
            is None

    def test_sample_publishes_breakdown_gauges(self, monkeypatch):
        telemetry.configure(None)
        rows = [
            {"device": i, "kind": "gpu", "bytes_in_use": 100 * (i + 1),
             "peak_bytes_in_use": 200 * (i + 1), "bytes_limit": 10_000}
            for i in range(4)
        ]
        monkeypatch.setattr(mem, "per_device_stats", lambda: rows)
        result = mem.sample("t")
        snap = telemetry.get_registry().snapshot()["gauges"]
        assert snap["mem.device.peak_bytes_in_use"] == 2000   # the sum
        assert snap["mem.device.peak_bytes_in_use_max"] == 800
        assert snap["mem.device.peak_bytes_in_use_min"] == 200
        assert snap["mem.device.imbalance"] == pytest.approx(0.75)
        assert result["devices_reporting"] == 4

    def test_memory_health_summary(self):
        metrics = {
            "counter.mem.samples": 3.0,
            "gauge.mem.device.bytes_in_use": 1000.0,
            "gauge.mem.device.peak_bytes_in_use": 2000.0,
            "gauge.mem.device.peak_bytes_in_use_max": 800.0,
            "gauge.mem.device.peak_bytes_in_use_min": 200.0,
            "gauge.mem.device.imbalance": 0.75,
            "gauge.mem.host.rss_bytes": 5000.0,
        }
        mh = memory_health(metrics)
        assert mh["samples"] == 3
        assert mh["per_device"]["imbalance"] == 0.75
        assert mh["per_device"]["peak_max"] == 800
        assert memory_health({"counter.serve.requests": 1.0}) is None


class TestRooflineHbm:
    def test_hbm_headroom_fields(self):
        peaks = {"flops_per_s": 1e12, "bytes_per_s": 1e11,
                 "hbm_bytes": 16 * 2**30}
        row = roofline_row(digest="d", label="l", calls=2, seconds=1.0,
                           est_flops=1e9, est_bytes=1e8, peaks=peaks,
                           mem_peak_bytes=4 * 2**30)
        assert row["hbm_bytes"] == 16 * 2**30
        assert row["hbm_frac"] == pytest.approx(0.25)
        assert row["hbm_headroom_bytes"] == 12 * 2**30
        row = roofline_row(digest="d", label="l", calls=2, seconds=1.0,
                           est_flops=1e9, est_bytes=1e8, peaks=peaks)
        assert "hbm_frac" not in row

    def test_override_peaks_keep_hbm(self):
        key, peaks = resolve_peaks("cpu", "", {
            "flops_per_s": 1e12, "bytes_per_s": 1e11, "hbm_bytes": 123})
        assert key == "override"
        assert peaks["hbm_bytes"] == 123
        _, cpu = resolve_peaks("cpu", "")
        assert cpu["hbm_bytes"] > 0
        # the card's row, which the scale record's budget reads
        _, h100 = resolve_peaks("gpu", "NVIDIA H100 80GB HBM3")
        assert h100["hbm_bytes"] == 80 * 2**30


class TestPrometheusScaleFamily:
    def test_scale_counters_expose(self):
        out = render({
            "counters": {"scale.probe_runs": 1, "scale.divergences": 0,
                         "scale.sharding_mismatches": 0},
            "gauges": {}, "histograms": {},
        })
        assert "stc_scale_probe_runs_total 1" in out
        assert "stc_scale_divergences_total 0" in out
        assert "stc_scale_sharding_mismatches_total 0" in out


def test_probe_registry_names():
    assert probe_spec_names() == [
        "em_lda.bucket_step",
        "online_lda.train_step",
        "sharded_eval.topic_inference",
        "sharded_eval.em_log_likelihood",
        "sharded_eval.top_terms",
    ]
    assert [(s.name, s.label, s.expects_sharding, s.note)
            for s in tsp.PROBE_SPECS] == [
        (s.name, s.label, s.expects_sharding, s.note)
        for s in jsp.PROBE_SPECS]


# ---------------------------------------------------------------------------
# parity with the JAX package where its half runs
# ---------------------------------------------------------------------------
def _case(name):
    """(evidence, record) of one planted case."""
    ev, rec = _evidence(), _record()
    e = _em(ev)
    if name == "over_tolerance":
        e["measured"]["per_chip_peak_bytes"] = int(2_100_000 * 1.3)
    elif name == "over_budget":
        e["measured"]["per_chip_peak_bytes"] = 2_100_000 * 30
    elif name == "collective_over":
        e["measured"]["collective_bytes_per_step"] = int(520_000 * 1.4)
    elif name == "replicated":
        e["model_sharded"] = False
    elif name == "retrace":
        e["retraces_after_first"] = 3
    elif name == "unavailable":
        e["measured"]["per_chip_peak_bytes"] = None
        e["measured"]["mem_source"] = "unavailable:no_record"
        e["measured"]["collective_bytes_per_step"] = None
    elif name == "no_row":
        rec = {"entries": {}}
    elif name == "unforced":
        ev["forced_model_sharding"] = False
        ev["mesh"] = {"data_shards": 1, "model_shards": 1}
    elif name == "no_record":
        rec = None
    elif name == "unobservable":
        e["model_sharded"] = None
    elif name == "two_entries":
        ev["entries"]["sharded_eval.top_terms"] = dict(
            copy.deepcopy(e), label="scale_probe.top_terms",
            note="no static scale record row")
    return ev, rec


CASES = ["clean", "over_tolerance", "over_budget", "collective_over",
         "replicated", "retrace", "unavailable", "no_row", "unforced",
         "no_record", "unobservable", "two_entries"]


@pytest.mark.parametrize("case", CASES)
def test_reconcile_and_measured_section_parity(case):
    ev, rec = _case(case)
    for kw in ({}, {"peak_tolerance": 0.5, "collective_tolerance": 0.1}):
        mine = reconcile(copy.deepcopy(ev), copy.deepcopy(rec), **kw)
        theirs = jsp.reconcile(copy.deepcopy(ev), copy.deepcopy(rec), **kw)
        assert mine == theirs
        assert measured_section(ev, mine) == jsp.measured_section(ev, theirs)


def test_constants_parity():
    assert tsp.PROBE_VERSION == jsp.PROBE_VERSION
    assert tsp.PROBE_DIMS == jsp.PROBE_DIMS
    assert tsp.WARM_STEPS == jsp.WARM_STEPS
    assert tsp.PEAK_TOLERANCE == jsp.PEAK_TOLERANCE
    assert tsp.COLLECTIVE_TOLERANCE == jsp.COLLECTIVE_TOLERANCE
    assert tsp.probe_spec_names() == jsp.probe_spec_names()
    # the same seeded arrays
    for mine, theirs in zip(tsp._probe_arrays(PROBE_DIMS),
                            jsp._probe_arrays(PROBE_DIMS)):
        assert (mine == theirs).all() and mine.dtype == theirs.dtype


def _cli(package, argv):
    """(rc, stdout) of one package's ``metrics scale-check <argv>``."""
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        if package == "jax":
            args = jcli.build_parser().parse_args(
                ["metrics", "scale-check", *argv])
            rc = args.fn(args)
        else:
            rc = main(["metrics", "scale-check", *argv])
    return rc, buf.getvalue()


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("case", [c for c in CASES if c != "no_record"])
def test_scale_check_json_parity(tmp_path, case, gate):
    """Both CLIs on the same planted probe and record: the same ``--json``
    document, the same summary line and exit code."""
    ev, rec = _case(case)
    argv = [_write_probe(tmp_path, ev), "--baseline",
            _write_record(tmp_path, rec), "--json"]
    if gate:
        argv.append("--fail-on-divergence")
    (jrc, jout), (trc, tout) = _cli("jax", argv), _cli("port", argv)
    assert trc == jrc
    jdoc, tdoc = (json.loads(o.splitlines()[0]) for o in (jout, tout))
    assert tdoc == jdoc
    assert tout.splitlines()[1:] == jout.splitlines()[1:]


def test_scale_check_write_record_parity(tmp_path):
    """``--write-record`` commits the same ``measured`` section into a
    copy of the same record, and a missing probe is exit 2 in both."""
    probe = _write_probe(tmp_path, _evidence())
    sections = []
    for package in ("jax", "port"):
        d = tmp_path / package
        d.mkdir()
        rec = _write_record(d)
        assert _cli(package, [probe, "--baseline", rec,
                              "--write-record"])[0] == 0
        with open(rec) as f:
            sections.append(json.load(f)["measured"])
        assert _cli(package, [str(d / "absent.json"), "--baseline",
                              rec])[0] == 2
    assert sections[0] == sections[1]
