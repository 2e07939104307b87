"""The port's lint layer 3 (``analysis.scale_audit`` over the scale specs
of ``analysis.entrypoints``) held against the JAX package's.

Four groups:

  * planted hazards, one test for each of the JAX package's
    ``tests/test_scale_audit.py`` self-tests, on torch fixtures built in
    the audit's fake mode (a [500, 10M] float32 leaf costs nothing): each
    plants its hazard in a throwaway ``ScaleSpec`` and the audit must flag
    exactly its rule, and nothing else; then the port's own hooks: host
    reads at scale (the stand-in table), a real buffer made in the call,
    a CUDA context, the default dtype restored;
  * the committed record's drift gate;
  * the registry at scale: every entry declares a spec, the sharded
    families reach V=10M / k=500, the grid branches key on the grid's
    shape (the audit grid has no process group), the two-entry smoke and
    the whole registry clean against the committed record, in time and
    memory;
  * parity where the JAX half runs here: each of JAX's 20 specs' dims,
    ``sharded_dims`` and ``model_shards``, the budget constants, both
    record comparisons on the same hand-made records, the record's keys.
    (The JAX package's audit itself needs ``jax.experimental.enable_x64``,
    which the installed jax may lack.)
"""

from __future__ import annotations

import json
import os
import resource
import time

import pytest
import torch

from spark_text_clustering_tpu_torch.analysis import entrypoints as tep
from spark_text_clustering_tpu_torch.analysis import findings as tfind
from spark_text_clustering_tpu_torch.analysis import scale_audit as tsa
from spark_text_clustering_tpu_torch.analysis.entrypoints import (
    ENTRYPOINTS,
    SCALE_K,
    SCALE_MODEL_SHARDS,
    SCALE_V,
    EntryPoint,
    ScaleDim,
    ScaleSpec,
)
from spark_text_clustering_tpu_torch.analysis.scale_audit import (
    audit_entry_scale,
    audit_grid,
    compare_with_record,
    fake_mode,
    run_scale_audit,
)
from spark_text_clustering_tpu_torch.parallel.collectives import (
    count_collectives,
    gather_model_rows_kbl,
    model_row_sum,
    psum_data,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO_ROOT, tsa.DEFAULT_SCALE_BASELINE_PATH)
JAX_RECORD = os.path.join(REPO_ROOT, "scripts", "records",
                          "scale_baseline.json")


def _rules(findings):
    return sorted({f.rule for f in findings})


def _f32(*shape):
    """A fake float32 leaf (scale builders run under the fake mode)."""
    with fake_mode():
        return torch.empty(shape, dtype=torch.float32)


def _spec(build, **dims):
    return ScaleSpec(dims={n: ScaleDim(p) if isinstance(p, tuple) else p
                           for n, p in dims.items()}, build=build)


def _waived(findings):
    baseline = tfind.Baseline.load(
        os.path.join(REPO_ROOT, tfind.DEFAULT_BASELINE_PATH))
    return tfind.apply_waivers(findings, baseline, check_stale=False)


# ---------------------------------------------------------------------------
# planted hazards
# ---------------------------------------------------------------------------
def test_planted_trace_failure_is_stc210():
    def build(dims):
        raise ValueError("no such factory")

    findings, record = audit_entry_scale(
        "selftest.broken", _spec(build, v=(1024,)))
    assert _rules(findings) == ["STC210"]
    assert record is None


def test_missing_scale_spec_is_stc210():
    ep = EntryPoint("selftest.nospec", False, lambda: (None, ()))
    findings, report = run_scale_audit([ep])
    assert _rules(findings) == ["STC210"]
    assert report["entries"] == {}


def _scaled(dims):
    return (lambda x: x * 2.0), (_f32(dims["b"], 16),)


def test_planted_unbucketed_dynamic_dim_is_stc211():
    """The signature changes between adjacent scale points along a dim
    the spec does not declare bucketed."""
    findings, record = audit_entry_scale(
        "selftest.storm", _spec(_scaled, b=ScaleDim((100, 101))))
    assert _rules(findings) == ["STC211"]
    assert "UNBUCKETED" in findings[0].message
    assert record is not None


def test_bucketed_pow2_grid_is_clean_but_non_pow2_is_stc211():
    findings, _ = audit_entry_scale(
        "selftest.buckets",
        _spec(_scaled, b=ScaleDim((512, 1024), bucketed=True)))
    assert findings == []
    findings, _ = audit_entry_scale(
        "selftest.crooked",
        _spec(_scaled, b=ScaleDim((100, 200), bucketed=True)))
    assert _rules(findings) == ["STC211"]
    assert "pow2" in findings[0].message


def test_planted_over_hbm_entry_is_stc212():
    """A [500, 10M] float32 lambda (20 GB) and three intermediates of its
    width held at once: 80 GB against the 72 GiB H100 budget."""
    def build(dims):
        def fn(lam):
            a = lam.exp()
            b = a * 2.0
            return a, b, a + b

        return fn, (_f32(dims["k"], dims["v"]),)

    findings, record = audit_entry_scale(
        "selftest.hbm", _spec(build, k=(SCALE_K,), v=(SCALE_V,)))
    assert _rules(findings) == ["STC212"]
    assert record["per_chip_peak_bytes"] == 4 * SCALE_K * SCALE_V * 4
    assert record["hbm_budget_bytes"] == int(80 * 2**30 * 0.9)


def test_live_bytes_count_a_storage_once_and_free_it():
    """The peak is the running sum of live storages: a temporary rebound
    in a loop is freed (argument, previous and new value at most), and a
    view adds nothing to its base's storage."""
    def build(dims):
        def fn(x):
            views = [x[:, :8]]
            for _ in range(5):
                x = x * 2.0
                views.append(x[:, :8])
            return x

        return fn, (_f32(dims["k"], dims["v"]),)

    findings, record = audit_entry_scale(
        "selftest.live", _spec(build, k=(SCALE_K,), v=(1 << 20,)))
    assert findings == []
    one = SCALE_K * (1 << 20) * 4
    # the views keep every value alive: argument and five products
    assert record["per_chip_peak_bytes"] == 6 * one

    def build_free(dims):
        def fn(x):
            for _ in range(5):
                x = x * 2.0
            return x

        return fn, (_f32(dims["k"], dims["v"]),)

    _, record = audit_entry_scale(
        "selftest.free", _spec(build_free, k=(SCALE_K,), v=(1 << 20,)))
    assert record["per_chip_peak_bytes"] == 3 * one


def _eb_build(sharded: bool):
    """exp(E[log beta]) of lambda: on the audit grid a card's shard, on
    one card the whole [k, V]."""
    def build(dims):
        grid = audit_grid() if sharded else None
        w = dims["v"] // SCALE_MODEL_SHARDS if sharded else dims["v"]

        def fn(lam):
            rows = (model_row_sum(grid, lam) if grid is not None
                    else lam.sum(dim=1))
            return torch.exp(torch.digamma(lam) - torch.digamma(rows)[:, None])

        return fn, (_f32(dims["k"], w),)

    return build


def test_sharded_entry_under_budget_is_clean_and_divides():
    """The same work vocab-sharded over 16 cards on the audit grid fits,
    at 1/16 of the replicated peak."""
    dims = dict(k=ScaleDim((SCALE_K,)), v=ScaleDim((SCALE_V,)))
    sharded = ScaleSpec(dims=dims, build=_eb_build(True),
                        sharded_dims=("v",))
    findings, rec = audit_entry_scale("selftest.sharded", sharded,
                                      multichip=True)
    assert findings == [], [f.message for f in findings]
    _, whole = audit_entry_scale(
        "selftest.whole", ScaleSpec(dims=dims, build=_eb_build(False)))
    assert rec["model_shards"] == 16 and whole["model_shards"] == 1
    assert rec["per_chip_peak_bytes"] * 16 == pytest.approx(
        whole["per_chip_peak_bytes"], rel=1e-4)


def test_planted_replication_gap_is_stc213():
    """Declared vocab-sharded, but the entry builds a full-V operand on
    the audit grid: it would run replicated."""
    def build(dims):
        def fn(lam):
            full = torch.zeros((lam.shape[0], dims["v"]), dtype=lam.dtype)
            return full.sum(dim=1) + lam.sum(dim=1)

        return fn, (_f32(8, dims["v"] // SCALE_MODEL_SHARDS),)

    spec = ScaleSpec(dims={"v": ScaleDim((1 << 20,))}, build=build,
                     sharded_dims=("v",))
    findings, _ = audit_entry_scale("selftest.replicated", spec,
                                    multichip=True)
    assert _rules(findings) == ["STC213"]
    assert any("replicated" in f.message for f in findings)


def test_planted_model_axis_gather_is_stc213():
    """``gather_model_rows_kbl`` of every vocabulary id: the model-axis
    gather of the sharded width."""
    def build(dims):
        grid = audit_grid()

        def fn(shard):
            with fake_mode():
                ids = torch.arange(dims["v"], dtype=torch.int64)
            return gather_model_rows_kbl(grid, shard, ids)

        return fn, (_f32(8, dims["v"] // SCALE_MODEL_SHARDS),)

    spec = ScaleSpec(dims={"v": ScaleDim((1 << 20,))}, build=build,
                     sharded_dims=("v",))
    findings, _ = audit_entry_scale("selftest.gather", spec, multichip=True)
    assert _rules(findings) == ["STC213"]
    assert any("gather" in f.message for f in findings)


def test_planted_collective_bytes_over_budget_is_stc214():
    def build(dims):
        grid = audit_grid()
        return (lambda x: psum_data(grid, x)), (_f32(1024, dims["v"]),)

    spec = _spec(build, v=(1 << 20,))     # a 4 GiB psum a step
    findings, record = audit_entry_scale("selftest.coll", spec)
    assert _rules(findings) == ["STC214"]
    assert record["collective_bytes_per_step"] == 1024 * (1 << 20) * 4
    # a raised per-entry budget silences exactly this rule; two steps a
    # call halve the per-step bytes
    raised = ScaleSpec(dims=spec.dims, build=build,
                       collective_budget_bytes=8 << 30)
    assert audit_entry_scale("selftest.coll2", raised)[0] == []
    two = ScaleSpec(dims=spec.dims, build=build, steps=2)
    findings, record = audit_entry_scale("selftest.coll3", two)
    assert findings == [] and record["collective_bytes_per_step"] == 2 << 30


def test_planted_scale_param_promotion_is_stc215():
    """A default-dtype operand that only the grid-max point adds: the
    output is float32 at the grid min and float64 (the hard mode's
    default) at the max."""
    def build(dims):
        big = dims["v"] >= 2**31

        def fn(ids, table):
            out = table[ids]
            return out + torch.zeros(out.shape) if big else out

        with fake_mode():
            ids = torch.empty((16,), dtype=torch.int64)
        return fn, (ids, _f32(64, 4))

    findings, _ = audit_entry_scale(
        "selftest.promote", _spec(build, v=ScaleDim((1 << 20, 1 << 32))))
    assert _rules(findings) == ["STC215"]
    assert "float32" in findings[0].message
    assert "float64" in findings[0].message


# ---------------------------------------------------------------------------
# the port's hooks: host reads, real buffers, the card, the default dtype
# ---------------------------------------------------------------------------
def test_numeric_host_read_without_stand_in_is_stc210():
    def build(dims):
        def fn(x):
            return x * int(x.sum())

        return fn, (_f32(dims["b"]),)

    findings, record = audit_entry_scale("selftest.read",
                                         _spec(build, b=(1024,)))
    assert _rules(findings) == ["STC210"] and record is None
    assert "no declared stand-in" in findings[0].message
    assert findings[0].snippet.startswith("aten._local_scalar_dense @ ")


def test_bool_read_runs_the_loop_to_max_inner():
    """A ``bool`` read answers "not converged": the fixed point runs to
    the ``max_inner`` its builder sets."""
    ran = []

    def build(dims):
        def fn(x):
            for _ in range(5):
                ran.append(1)
                x = x * 0.5
                if bool((x.abs() < 1e-3).all()):
                    break
            return x

        return fn, (_f32(dims["b"], 500),)

    findings, _ = audit_entry_scale("selftest.loop", _spec(build, b=(1024,)))
    assert findings == [] and len(ran) == 5


def test_declared_stand_in_answers_a_numeric_read(monkeypatch):
    """A numeric read answers its site's declared values in call order; a
    string names a scale dim."""
    seen = []

    def build(dims):
        def fn(x):
            seen.extend([int(x.sum()), float(x.mean())])
            return x

        return fn, (_f32(dims["b"]),)

    monkeypatch.setitem(tsa.STAND_INS,
                        "aten._local_scalar_dense @ ?", (3, "b"))
    findings, _ = audit_entry_scale("selftest.standin",
                                    _spec(build, b=(512,)))
    assert findings == [] and seen == [3, 512.0]


def test_tensor_numpy_of_a_fake_tensor_is_stc210():
    def build(dims):
        return (lambda x: x.numpy()), (_f32(dims["b"]),)

    findings, record = audit_entry_scale("selftest.numpy",
                                         _spec(build, b=(1024,)))
    assert _rules(findings) == ["STC210"] and record is None
    assert findings[0].snippet.startswith("Tensor.numpy @ ")


def test_real_tensor_made_in_the_call_is_stc210():
    """A 2 MiB real buffer made in the call (the fake mode stepped out
    of) is an entry materialising a buffer at scale; a 1 MiB one is a
    host plan."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def build_of(n):
        def build(dims):
            def fn(x):
                with unset_fake_temporarily():
                    host = torch.zeros(n, dtype=torch.float32)
                return x.sum() + host.sum()

            return fn, (_f32(dims["b"]),)

        return build

    findings, _ = audit_entry_scale("selftest.real",
                                    _spec(build_of(512 * 1024), b=(8,)))
    assert _rules(findings) == ["STC210"]
    assert "materialised" in findings[0].message
    findings, _ = audit_entry_scale("selftest.plan",
                                    _spec(build_of(256 * 1024), b=(8,)))
    assert findings == []


def test_a_cuda_context_is_stc210(monkeypatch):
    state = {"up": False}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: state["up"])

    def build(dims):
        def fn(x):
            state["up"] = True
            return x

        return fn, (_f32(dims["b"]),)

    findings, _ = audit_entry_scale("selftest.cuda", _spec(build, b=(8,)))
    assert _rules(findings) == ["STC210"]
    assert "CUDA context" in findings[0].message


def test_default_dtype_restored_after_a_raising_entry():
    def build(dims):
        def fn(x):
            raise RuntimeError("boom")

        return fn, (_f32(dims["b"]),)

    before = torch.get_default_dtype()
    findings, _ = audit_entry_scale("selftest.raise", _spec(build, b=(8,)))
    assert _rules(findings) == ["STC210"]
    assert torch.get_default_dtype() == before


def test_fake_mode_outside_the_audit_raises():
    """A scale builder called outside the audit would allocate its scale
    point for real: its leaves refuse."""
    with pytest.raises(RuntimeError, match="only under the scale audit"):
        fake_mode()


# ---------------------------------------------------------------------------
# committed scale record drift gate (JAX's cases)
# ---------------------------------------------------------------------------
def _report(**entries):
    return {"version": 1, "backend": "nvidia-h100", "entries": entries}


def _entry(sig, peak):
    return {"signature": sig, "per_chip_peak_bytes": peak}


def test_missing_record_and_entry_set_drift_are_stc210():
    rep = _report(a=_entry(["[4]"], 100))
    assert _rules(compare_with_record(rep, None, "scale_baseline.json")) \
        == ["STC210"]
    rec = _report(a=_entry(["[4]"], 100), gone=_entry(["[4]"], 100))
    rep2 = _report(a=_entry(["[4]"], 100), fresh=_entry(["[4]"], 100))
    findings = compare_with_record(rep2, rec, "scale_baseline.json")
    assert sorted(f.path for f in findings) == ["scale:fresh", "scale:gone"]
    assert _rules(findings) == ["STC210"]


def test_signature_and_peak_drift_gate():
    rec = _report(a=_entry(["[4]"], 1000))
    assert _rules(compare_with_record(
        _report(a=_entry(["[8]"], 1000)), rec, "b.json")) == ["STC211"]
    assert _rules(compare_with_record(
        _report(a=_entry(["[4]"], 2000)), rec, "b.json")) == ["STC212"]
    assert compare_with_record(
        _report(a=_entry(["[4]"], 1050)), rec, "b.json") == []


def test_save_keeps_the_measured_section(tmp_path):
    path = str(tmp_path / "rec.json")
    with open(path, "w") as f:
        json.dump({"entries": {}, "measured": {"geometry": "g"}}, f)
    tsa.save_scale_record(_report(a=_entry(["[4]"], 1)), path)
    assert tsa.load_scale_record(path)["measured"] == {"geometry": "g"}
    assert tsa.load_scale_record(str(tmp_path / "none.json")) is None


# ---------------------------------------------------------------------------
# the registry at scale
# ---------------------------------------------------------------------------
def test_every_registered_entry_declares_scale_shapes():
    missing = [ep.name for ep in ENTRYPOINTS if ep.scale is None]
    assert missing == [], missing
    assert len(ENTRYPOINTS) >= 29


def test_vocab_sharded_families_reach_ccnews_scale():
    for family in ("em_lda.", "online_lda.", "sharded_eval.", "nmf.",
                   "em.", "online."):
        eps = [ep for ep in ENTRYPOINTS
               if ep.name.startswith(family) and "v" in ep.scale.dims]
        assert eps, family
        assert any(ep.scale.dims["v"].points[-1] >= SCALE_V
                   and ep.scale.dims["k"].points[-1] >= SCALE_K
                   and ep.scale.sharded_dims == ("v",)
                   for ep in eps), family


def test_kernel_entries_carry_their_cost_bytes():
    with open(RECORD) as f:
        entries = json.load(f)["entries"]
    io = {n for n, e in entries.items() if "kernel_io_bytes" in e}
    assert io == {"ops.pallas_estep.gamma_fixed_point_bkl",
                  "ops.pallas_packed.gamma_fixed_point_tiles",
                  "ops.pallas_nmf.mu_update_tiles",
                  "score.topic_inference_segments",
                  "serving.topic_inference_frozen"}
    for n in io:
        assert 0 < entries[n]["kernel_io_bytes"], n
        assert "plain version" in entries[n]["note"], n


def test_stand_ins_sit_beside_waived_host_reads():
    """Every declared stand-in answers a read that layer 2 waives as
    STC203 at the same site: the design's host reads are named once."""
    with open(os.path.join(REPO_ROOT, tfind.DEFAULT_BASELINE_PATH)) as f:
        matches = {w["match"] for w in json.load(f)["waivers"]
                   if w["rule"] == "STC203"}
    for key in tsa.STAND_INS:
        assert any(key.startswith(m) for m in matches), key


def test_grid_branches_key_on_the_grid_shape():
    """On the audit grid (1 x 4 here, no process group) the fits cut the
    vocabulary as rank 0 of a 4-card row would, and the collectives run
    through their no-group return: the grid branch keys on
    ``model_shards`` / ``m``, not on a group being present."""
    import numpy as np

    from spark_text_clustering_tpu_torch.config import Params
    from spark_text_clustering_tpu_torch.models.em_lda import EMLDA
    from spark_text_clustering_tpu_torch.models.sharded_eval import (
        shard_col_mask,
    )

    grid = audit_grid(4)
    assert grid.model_group is None and grid.data_group is None
    k, v = 3, 64
    rows = [(np.arange(8, dtype=np.int32) * 8 + j, np.ones(8, np.float32))
            for j in range(6)]
    for layout in ("_padded_grid", "_packed_grid"):
        est = EMLDA(Params(k=k, algorithm="em"), device="cpu")
        est.grid = grid
        lay = getattr(est, layout)(rows, v, v, k, est.params.resolved_alpha(),
                                   est.params.resolved_eta())
        n_wk, n_dk = lay.put(np.ones((k, v), np.float32),
                             np.ones((len(rows), k), np.float32))
        assert n_wk.shape == (k, v // 4), layout
        with count_collectives() as calls:
            out, _ = lay.sweep(n_wk, n_dk)
        assert out.shape == (k, v // 4) and calls, layout
    assert int(shard_col_mask(grid, v // 4, v, "cpu").sum()) == v // 4
    # no code outside the collectives keys on a group
    pkg = os.path.join(REPO_ROOT, "spark_text_clustering_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            path = os.path.join(dirpath, name)
            if not name.endswith(".py") or path.endswith(
                    os.path.join("parallel", "collectives.py")):
                continue
            with open(path) as f:
                src = f.read()
            assert "_group is None" not in src, path


def test_registry_scale_smoke_two_entries():
    """One vocab-sharded step and the packed log-likelihood audit clean
    at full scale, the step's 20 GB lambda a card's 1/16."""
    subset = [ep for ep in ENTRYPOINTS
              if ep.name in ("em_lda.bucket_step", "em_lda.packed_loglik")]
    findings, report = run_scale_audit(subset)
    assert findings == [], [f"{f.path}: {f.rule}: {f.message}"
                            for f in findings]
    rec = report["entries"]["em_lda.bucket_step"]
    assert rec["per_chip_peak_bytes"] < rec["hbm_budget_bytes"]
    assert rec["model_shards"] == 16
    assert rec["signature"][0] == f"[{SCALE_K},{SCALE_V // 16}]"


def test_full_registry_clean_against_the_record_fast_and_small():
    """The whole registry at scale: clean under the port's waivers, equal
    to the committed record (no drift), under 60 s, and the process's
    peak resident memory grows by under 1 GiB (every tensor fake)."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    findings, report = run_scale_audit()
    seconds = time.perf_counter() - t0
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    findings += compare_with_record(report, tsa.load_scale_record(RECORD),
                                    tsa.DEFAULT_SCALE_BASELINE_PATH)
    assert len(report["entries"]) == len(ENTRYPOINTS)
    unwaived = [f for f in _waived(findings) if not f.waived]
    assert unwaived == [], [f"{f.path}: {f.rule}: {f.message}"
                            for f in unwaived]
    assert seconds < 60.0, seconds
    assert grown < 1 << 30, grown
    assert report["backend"] == "nvidia-h100"


# ---------------------------------------------------------------------------
# parity with the JAX package where its half runs
# ---------------------------------------------------------------------------
def test_scale_specs_parity_with_jax():
    """JAX's 20 names: equal dims (points and ``bucketed``),
    ``sharded_dims`` and ``model_shards``; the scale constants equal."""
    from spark_text_clustering_tpu.analysis import entrypoints as jep

    def dims(spec):
        return {n: (d.points, d.bucketed) for n, d in spec.dims.items()}

    port = {ep.name: ep.scale for ep in ENTRYPOINTS}
    assert len(jep.ENTRYPOINTS) == 20
    for ep in jep.ENTRYPOINTS:
        j, t = ep.scale, port[ep.name]
        assert dims(t) == dims(j), ep.name
        assert t.sharded_dims == j.sharded_dims, ep.name
        assert t.model_shards == j.model_shards, ep.name
    for name in ("SCALE_K", "SCALE_V", "SCALE_MODEL_SHARDS", "_SCALE_B",
                 "_SCALE_L", "_SCALE_T", "_SCALE_TILES", "_SCALE_TT",
                 "_SCALE_D", "_SCALE_SERVE_T"):
        assert getattr(tep, name) == getattr(jep, name), name
    assert tep.ScaleSpec.__dataclass_fields__["model_shards"].default \
        == jep.SCALE_MODEL_SHARDS


def test_budget_constants_parity():
    from spark_text_clustering_tpu.analysis import scale_audit as jsa

    for name in ("HBM_UTILIZATION", "COLLECTIVE_BUDGET_BYTES",
                 "PEAK_DRIFT_TOLERANCE", "MEASURED_DRIFT_TOLERANCE"):
        assert getattr(tsa, name) == getattr(jsa, name), name
    # the port's own backend: 72 GiB of the H100's 80
    assert tsa.DEFAULT_BACKEND == "nvidia-h100"
    assert tsa._hbm_budget_bytes(tsa.DEFAULT_BACKEND) == 77_309_411_328


_RECORDS = [
    (_report(a=_entry(["[4]"], 100)), None),
    (_report(a=_entry(["[4]"], 100), fresh=_entry(["[4]"], 1)),
     _report(a=_entry(["[4]"], 100), gone=_entry(["[4]"], 1))),
    (_report(a=_entry(["[8]"], 1000)), _report(a=_entry(["[4]"], 1000))),
    (_report(a=_entry(["[4]"], 2000)), _report(a=_entry(["[4]"], 1000))),
    (_report(a=_entry(["[4]"], 1050)), _report(a=_entry(["[4]"], 1000))),
    (_report(a=_entry(["[4]"], 100)), _report(a={"signature": ["[4]"]})),
]


@pytest.mark.parametrize("report,record", _RECORDS)
def test_compare_with_record_parity(report, record):
    from spark_text_clustering_tpu.analysis import scale_audit as jsa

    def key(fs):
        return sorted((f.rule, f.path, f.snippet) for f in fs)

    assert key(compare_with_record(report, record, "b.json")) == key(
        jsa.compare_with_record(report, record, "b.json"))


_MEASURED = {"geometry": {"k": 500}, "mesh": [1, 4], "entries": {
    "a": {"peak_ratio": 1.0, "collective_ratio": 0.5, "model_sharded": True},
    "b": {"peak_ratio": 0.9}}}


@pytest.mark.parametrize("fresh", [
    _MEASURED,
    {**_MEASURED, "mesh": [2, 2]},
    {**_MEASURED, "entries": {
        "a": {"peak_ratio": 1.5, "collective_ratio": 0.5,
              "model_sharded": False},
        "b": {"peak_ratio": 0.95}}},
])
def test_compare_measured_with_record_parity(fresh):
    from spark_text_clustering_tpu.analysis import scale_audit as jsa

    record = {"entries": {}, "measured": _MEASURED}
    assert tsa.compare_measured_with_record(fresh, record) == \
        jsa.compare_measured_with_record(fresh, record)
    assert tsa.compare_measured_with_record(fresh, None) == []


def test_committed_record_keys_cover_jax_record():
    """The port's record: all entries at ``nvidia-h100``, the measured
    section the card's (``metrics scale-check --write-record`` on the
    2x2 grid of ranks, item 10c.3) with the JAX section's keys, its
    top-level and per-entry keys a superset of the JAX package's
    record's."""
    with open(RECORD) as f:
        port = json.load(f)
    with open(JAX_RECORD) as f:
        jax_rec = json.load(f)
    assert set(port) >= set(jax_rec)
    assert set(port["measured"]) == set(jax_rec["measured"])
    assert port["measured"]["backend"] == "cuda"
    assert sorted(port["measured"]["entries"]) == sorted(
        jax_rec["measured"]["entries"])
    assert port["backend"] == "nvidia-h100"
    assert sorted(port["entries"]) == sorted(ep.name for ep in ENTRYPOINTS)
    jax_keys = set().union(*(set(e) for e in jax_rec["entries"].values()))
    for name, e in port["entries"].items():
        assert set(e) >= jax_keys - {"note"}, name
        assert e["backend"] == "nvidia-h100", name
