"""The port's queueing estimation (``telemetry/queueing.py``) against the
JAX package's on the same inputs and event sequences: Erlang C, the
predicted M/M/c waits, the windowed λ/S/ρ estimator and the predictive
autoscaler's decisions, to rtol 1e-12 (the same float64 arithmetic)."""

from __future__ import annotations

import math

import numpy as np
import pytest

from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.telemetry import queueing as jq
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.telemetry import queueing as tq


@pytest.fixture(autouse=True)
def _registries():
    for tel in (telemetry, jtelemetry):
        tel.configure(None)
    yield
    for tel in (telemetry, jtelemetry):
        tel.shutdown()


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _close(a[key], b[key])
    elif isinstance(a, float) and isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            assert a == b
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=0.0)
    else:
        assert a == b


@pytest.mark.parametrize("c", [1, 2, 3, 8, 32])
def test_erlang_c_and_predicted_waits_match_jax(c):
    for a in (0.0, 0.05, 0.5, 0.9 * c, c - 1e-3, c, 2.0 * c):
        _close(tq.erlang_c(c, a), jq.erlang_c(c, a))
    for lam, s in ((0.0, 0.1), (3.0, 0.01), (40.0, 0.02), (c / 0.05, 0.05),
                   (5.0, 0.0), (-1.0, 0.1), (250.0, 0.9)):
        _close(tq.predicted_waits(c, lam, s), jq.predicted_waits(c, lam, s))


def _events(seed, n=400):
    """(ts, event) pairs: arrivals from a front and a probe, and serve
    batches from three replicas' streams, some without a wait field, and
    a few malformed records the estimator must skip."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.exponential(0.05, n)) + 1000.0
    out = []
    for i, t in enumerate(ts):
        kind = rng.integers(0, 5)
        if kind == 0:
            e = {"event": "front_request"}
        elif kind == 1:
            e = {"event": "probe_request"}
        elif kind == 2:
            e = {"event": "train_fit", "docs": 3}
        else:
            e = {"event": "serve_batch", "docs": int(rng.integers(1, 9)),
                 "seconds": float(rng.gamma(2.0, 0.01)),
                 "_stream": f"worker-w{int(rng.integers(0, 3)):03d}-s0.jsonl"}
            if rng.random() < 0.7:
                e["wait"] = float(rng.exponential(0.02))
            if i % 97 == 0:
                e["docs"] = True            # malformed: a bool
        out.append((float(t), e))
    return out


@pytest.mark.parametrize("seed,window,replicas", [(0, 30.0, None),
                                                  (1, 2.0, 2), (2, 10.0, 1)])
def test_queueing_estimator_matches_jax(seed, window, replicas):
    """The same events fed to both estimators, an estimate after every
    tenth: equal estimates and equal published gauges."""
    est = {name: mod.QueueingEstimator(window, replica_count=replicas)
           for name, mod in (("jax", jq), ("port", tq))}
    assert est["port"].estimate(0.0) is None
    for i, (ts, e) in enumerate(_events(seed)):
        for x in est.values():
            x.observe_event(ts, e)
            x.note_arrivals(int(i % 3), ts)
        if i % 10 == 9:
            _close(est["port"].estimate(ts + 0.01),
                   est["jax"].estimate(ts + 0.01))
    gauges = [tel.get_registry().snapshot()["gauges"]
              for tel in (telemetry, jtelemetry)]
    _close(gauges[0], gauges[1])
    assert any(k.startswith("queueing.replica.") for k in gauges[0])


def test_predictive_autoscaler_matches_jax():
    """A ρ trace through hot, dead-band and cold stretches, with a
    cooldown and clamps: the same decisions at the same times."""
    rng = np.random.default_rng(4)
    scalers = [mod.PredictiveAutoscaler(
        min_replicas=1, max_replicas=4, high_rho=0.8, low_rho=0.3,
        confirm=2, cooldown_seconds=5.0) for mod in (tq, jq)]
    rhos = np.concatenate([rng.uniform(0.85, 1.5, 30),
                           rng.uniform(0.35, 0.75, 10),
                           rng.uniform(0.0, 0.25, 40)])
    decisions = [[], []]
    current = 2
    for i, rho in enumerate(rhos):
        estimate = {"rho": float(rho), "replicas": current}
        if i % 17 == 16:
            estimate = {"replicas": current}          # no service signal
        got = [s.decide(estimate, 100.0 + i, current=current)
               for s in scalers]
        _close(got[0], got[1])
        for d, g in zip(decisions, got):
            d.append(g)
        if got[0] is not None:
            current = got[0]["to"]
    assert any(d and d["action"] == "scale_out" for d in decisions[0])
    assert any(d and d["action"] == "scale_in" for d in decisions[0])
    assert scalers[0].decide(None, 1.0) is None
    for mod in (tq, jq):
        with pytest.raises(ValueError):
            mod.PredictiveAutoscaler(high_rho=0.3, low_rho=0.3)
