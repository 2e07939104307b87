"""The port's lint layer 2 (``analysis.jaxpr_audit`` over
``analysis.entrypoints``) held against the JAX package's.

Three groups:

  * planted hazards, one test for each of the JAX package's
    ``tests/test_jaxpr_audit.py`` self-tests, on torch fixtures: each
    plants its hazard in a throwaway function and the audit must flag
    exactly its rule (STC200-205 read for torch), and nothing else;
  * the registry: its width and families, the two-entry smoke and the
    whole registry clean under the port's reasoned waivers, every
    dispatch label of the package covered;
  * parity where the JAX half runs here: the registry's names and
    ``multichip`` flags, ``CONST_BUDGET_BYTES``, the ``jaxpr:<name>``
    paths and STC200's contract.  (The JAX package's audit itself fails
    wherever the installed jax lacks ``jax.experimental.enable_x64``.)
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.analysis import ast_rules
from spark_text_clustering_tpu_torch.analysis import findings as tfind
from spark_text_clustering_tpu_torch.analysis.entrypoints import (
    ENTRY_LABELS,
    ENTRYPOINTS,
    EntryPoint,
    entrypoint_names,
)
from spark_text_clustering_tpu_torch.analysis.jaxpr_audit import (
    CONST_BUDGET_BYTES,
    audit_entry,
    run_jaxpr_audit,
)
from spark_text_clustering_tpu_torch.parallel.collectives import psum_data
from spark_text_clustering_tpu_torch.parallel.mesh import make_grid

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rules(findings):
    return sorted({f.rule for f in findings})


def _x():
    return torch.ones(4, dtype=torch.float32)


def _waived(findings):
    baseline = tfind.Baseline.load(
        os.path.join(REPO_ROOT, tfind.DEFAULT_BASELINE_PATH))
    return tfind.apply_waivers(findings, baseline, check_stale=False)


# ---------------------------------------------------------------------------
# planted hazards
# ---------------------------------------------------------------------------
def test_planted_float64_is_flagged():
    def planted(x):
        return x * torch.tensor(1.0, dtype=torch.float64)

    findings, n_ops = audit_entry("selftest.f64", planted, (_x(),))
    assert _rules(findings) == ["STC201"]
    assert n_ops > 0


@pytest.mark.parametrize("source", ["default_dtype", "from_numpy"])
def test_float64_leaks_read_for_torch(source):
    """The hard mode is the float64 default dtype: a tensor left to the
    default leaks under it only, ``from_numpy`` of a float64 array in
    both modes."""
    def planted(x):
        if source == "default_dtype":
            return x + torch.zeros(4)
        return x + torch.from_numpy(np.ones(4))

    hard, _ = audit_entry("selftest.leak", planted, (_x(),))
    soft, _ = audit_entry("selftest.leak", planted, (_x(),),
                          enable_x64=False)
    assert _rules(hard) == ["STC201"]
    assert _rules(soft) == ([] if source == "default_dtype" else ["STC201"])


@pytest.mark.parametrize("read", [
    lambda x: x.sum().item(),
    lambda x: float(x[0]),
    lambda x: int(x[1]),
    lambda x: bool(x[0] > 0),
    lambda x: x.numpy(),
    lambda x: x.tolist(),
    lambda x: x.cpu(),
], ids=["item", "float", "int", "bool", "numpy", "tolist", "cpu"])
def test_planted_host_read_is_flagged(read):
    def planted(x):
        read(x)
        return x * 2.0

    findings, _ = audit_entry("selftest.read", planted, (_x(),))
    assert _rules(findings) == ["STC203"]
    assert len(findings) == 1


def test_host_reads_inside_device_sync_are_exempt():
    """A read made while ``telemetry.device_sync`` runs is exempt, as in
    STC005: here the read happens when device_sync asks its argument for
    its device."""
    class Probe:
        def __init__(self, t):
            self.t = t

        @property
        def device(self):
            self.t.sum().item()
            assert telemetry.in_device_sync()
            return self.t.device

    def planted(x):
        telemetry.device_sync(Probe(x), "selftest")
        return x * 2.0

    findings, _ = audit_entry("selftest.sync", planted, (_x(),))
    assert findings == []
    assert not telemetry.in_device_sync()


def test_planted_f64_and_host_read_together():
    """The canonical self-test: BOTH hazards in one fn, both flagged in
    one audit pass."""
    def planted(x):
        y = x + torch.tensor(2.0, dtype=torch.float64)
        return y * float(y.sum())

    findings, _ = audit_entry("selftest.both", planted, (_x(),))
    assert _rules(findings) == ["STC201", "STC203"]


@pytest.mark.parametrize("out", [
    lambda x: 2.0 * 3,
    lambda x: np.float32(1.0),
    lambda x: (x, 7),
], ids=["python_float", "numpy_scalar", "int_in_tuple"])
def test_python_scalar_output_is_flagged(out):
    findings, _ = audit_entry("selftest.weak", out, (_x(),),
                              enable_x64=False)
    assert _rules(findings) == ["STC202"]


def test_oversized_captured_tensor_is_flagged():
    big = torch.ones(CONST_BUDGET_BYTES // 4 + 16, dtype=torch.float32)

    def planted(x):
        return x[0] * big

    findings, _ = audit_entry("selftest.const", planted, (_x(),))
    assert _rules(findings) == ["STC204"]
    # the same tensor as an argument is no capture
    findings, _ = audit_entry(
        "selftest.const", lambda x, b: x[0] * b, (_x(), big))
    assert findings == []


def test_missing_collective_flagged_for_multichip_entry():
    findings, _ = audit_entry("selftest.nosharding", lambda x: x * 2.0,
                              (_x(),), multichip=True)
    assert _rules(findings) == ["STC205"]
    grid = make_grid(1, 1, device="cpu")
    findings, _ = audit_entry(
        "selftest.sharding", lambda x: psum_data(grid, x * 2.0), (_x(),),
        multichip=True)
    assert findings == []


def test_clean_fn_produces_no_findings():
    def clean(x):
        return (x * 2.0).sum()

    findings, _ = audit_entry("selftest.clean", clean, (_x(),))
    assert findings == []


def test_raising_builder_and_call_are_stc200():
    """A broken registration fails lint as a finding, not the linter."""
    def boom():
        raise ValueError("boom")

    def bad_call():
        return (lambda x: x.missing()), (_x(),)

    findings, audited = run_jaxpr_audit([
        EntryPoint("selftest.raise", False, boom),
        EntryPoint("selftest.call", False, bad_call),
        EntryPoint("selftest.ok", False, lambda: (lambda x: x * 2.0,
                                                   (_x(),))),
    ])
    assert audited == ["selftest.ok"]
    assert [(f.rule, f.path) for f in findings] == [
        ("STC200", "jaxpr:selftest.raise"), ("STC200", "jaxpr:selftest.call")]
    assert findings[0].message == (
        "entry point failed to build/trace: ValueError: boom")


def test_a_cuda_context_is_stc200(monkeypatch):
    """The audit must never touch the card: a CUDA context that appears
    during the call is STC200 (JAX pins the CPU platform instead)."""
    state = {"init": False}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: state["init"])

    def planted(x):
        state["init"] = True
        return x * 2.0

    findings, _ = audit_entry("selftest.cuda", planted, (_x(),))
    assert _rules(findings) == ["STC200"]


def test_default_dtype_restored_after_a_raising_entry():
    def planted(x):
        assert torch.get_default_dtype() == torch.float64
        raise RuntimeError("planted")

    before = torch.get_default_dtype()
    with pytest.raises(RuntimeError, match="planted"):
        audit_entry("selftest.raise", planted, (_x(),))
    assert torch.get_default_dtype() == before == torch.float32
    findings, audited = run_jaxpr_audit(
        [EntryPoint("selftest.raise", False, lambda: (planted, (_x(),)))])
    assert _rules(findings) == ["STC200"] and audited == []
    assert torch.get_default_dtype() == torch.float32


# ---------------------------------------------------------------------------
# registry coverage
# ---------------------------------------------------------------------------
def test_registry_width_and_span():
    names = entrypoint_names()
    assert len(names) >= 20 and len(set(names)) == len(names)
    for family in (
        "em_lda.", "online_lda.", "nmf.", "ops.pallas_", "sharded_eval.",
    ):
        assert any(n.startswith(family) for n in names), family
    # every entry declares its scale shapes (layer 3, the scale audit)
    assert all(ep.scale is not None for ep in ENTRYPOINTS)


def test_registered_entrypoints_audit_clean_smoke():
    """Two representative entries (one grid step, one kernel wrapper)
    audit clean under the port's reasoned waivers."""
    subset = [
        ep for ep in ENTRYPOINTS
        if ep.name in (
            "em_lda.bucket_step",
            "ops.pallas_estep.gamma_fixed_point_bkl",
        )
    ]
    findings, audited = run_jaxpr_audit(subset)
    assert sorted(audited) == [
        "em_lda.bucket_step",
        "ops.pallas_estep.gamma_fixed_point_bkl",
    ]
    out = _waived(findings)
    assert not [f for f in out if not f.waived], [f.message for f in out]


def test_full_registry_audits_clean():
    """Every entry builds and runs on the CPU without a CUDA context;
    every finding carries a reasoned waiver and no jaxpr waiver is
    stale."""
    findings, audited = run_jaxpr_audit()
    assert audited == entrypoint_names()
    assert not torch.cuda.is_initialized()
    baseline = tfind.Baseline.load(
        os.path.join(REPO_ROOT, tfind.DEFAULT_BASELINE_PATH))
    out = tfind.apply_waivers(findings, baseline,
                              stale_exempt_prefixes=(
                                  "spark_text_clustering_tpu_torch/",
                                  "scale:", "protocol:"))
    assert not [f for f in out if not f.waived], [
        f"{f.path}: {f.rule}: {f.message}" for f in out if not f.waived]
    assert all(f.reason for f in out)


def test_every_dispatch_label_is_covered():
    """Every label passed to ``telemetry.instrument_dispatch`` in the
    package (found at STC005's roots) resolves to strings, and an entry
    covers each one; the map covers exactly the registry."""
    labels, unresolved = ast_rules.dispatch_labels(REPO_ROOT)
    assert unresolved == []
    assert len(labels) >= 27
    covered = {lb for lbs in ENTRY_LABELS.values() for lb in lbs}
    assert sorted(set(labels) - covered) == []
    assert sorted(covered - set(labels)) == []
    assert sorted(ENTRY_LABELS) == sorted(entrypoint_names())


def test_entries_bind_the_callables_their_labels_wrap():
    """An entry whose callable is itself an ``instrument_dispatch``
    wrapper carries one of the entry's labels."""
    seen = 0
    for ep in ENTRYPOINTS:
        fn, _ = ep.build()
        fn = getattr(fn, "func", fn)          # through functools.partial
        label = getattr(fn, "dispatch_label", None)
        if label is not None:
            seen += 1
            assert label in ENTRY_LABELS[ep.name], (ep.name, label)
    assert seen >= 10


# ---------------------------------------------------------------------------
# parity with the JAX package where its half runs
# ---------------------------------------------------------------------------
def test_registry_names_and_multichip_parity():
    from spark_text_clustering_tpu.analysis import entrypoints as jent

    port = {ep.name: ep.multichip for ep in ENTRYPOINTS}
    jax_names = jent.entrypoint_names()
    assert len(jax_names) == 20
    assert set(jax_names) <= set(port)
    for ep in jent.ENTRYPOINTS:
        assert port[ep.name] == ep.multichip, ep.name
    assert entrypoint_names()[:20] == jax_names


def test_const_budget_and_geometry_parity():
    from spark_text_clustering_tpu.analysis import entrypoints as jent
    from spark_text_clustering_tpu.analysis import jaxpr_audit as jaudit
    from spark_text_clustering_tpu_torch.analysis import entrypoints as tent

    assert CONST_BUDGET_BYTES == jaudit.CONST_BUDGET_BYTES == 1 << 20
    assert (tent.K, tent.V, tent.B, tent.L, tent.T) == (
        jent.K, jent.V, jent.B, jent.L, jent.T)


def test_stc200_contract_parity():
    """A raising builder gives the same finding in both packages: rule,
    ``jaxpr:<name>`` path, line and message."""
    from spark_text_clustering_tpu.analysis import entrypoints as jent
    from spark_text_clustering_tpu.analysis import jaxpr_audit as jaudit

    def boom():
        raise ValueError("boom")

    got = []
    for mod, ep_cls in ((jaudit, jent.EntryPoint), (None, EntryPoint)):
        run = mod.run_jaxpr_audit if mod else run_jaxpr_audit
        findings, audited = run([ep_cls("selftest.raise", False, boom)])
        assert audited == []
        got.append([f.to_dict() for f in findings])
    assert got[0] == got[1]
    assert got[1][0]["path"] == "jaxpr:selftest.raise"
