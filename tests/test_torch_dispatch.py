"""The port's dispatch layer held against the JAX package's.

The same six small books go through both CLIs in this process, JAX's on
a one-device mesh and the port's with ``--device cpu``: ``train`` (EM,
online VB, NMF) and ``score``, each with ``--telemetry-file``.  Digests
differ between the packages (each hashes its own signatures), so the
streams are compared by label: the labels of the ``dispatch_executable``
events, the recompile sentinel's ``compile.<label>.signatures`` and
``compile.retraces``, and the calls per label.  The NMF fit takes the
port's tiled layout on every device (JAX tiles only where its kernel
runs), so its label is ``nmf.fused_chunk`` where JAX's CPU run says
``nmf.packed_chunk`` (``test_torch_telemetry.PORT_LABELS``).

Then the parts the CLI cannot show on the CPU: each kernel's ``cost()``
against a hand count, and ``chip_smoke``'s bound helpers against the
times those costs give; a kernel launch inside an instrumented call
charged to it (count, cost, scratch); ``mem.<digest>.*`` against the
call's tensors; and nothing recorded with telemetry disabled.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from spark_text_clustering_tpu.telemetry import dispatch as jdispatch
from spark_text_clustering_tpu.telemetry import events as jevents
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.ops import (
    _build, emscatter, emsweep, estep, nmf, packed, segments,
)
from spark_text_clustering_tpu_torch.telemetry import dispatch, roofline
from test_torch_telemetry import (
    PORT_LABELS, jax_main, port_main, python_text_paths, run,
)

K = 3
VERBS = ("train", "train:online", "train:nmf", "score")


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{verb: {"jax": events, "port": events}} of each CLI's run."""
    root = tmp_path_factory.mktemp("dispatch_books")
    stop = chip_smoke.en_books_dir(7, str(root), n_books=6,
                                   words=(300, 1500))
    books = str(root / "books")
    out = {}
    with python_text_paths():
        for name, main, module in (("jax", jax_main, jdispatch),
                                   ("port", port_main, dispatch)):
            module.reset()
            work = root / name
            common = ["--books", books, "--stop-words", stop, "--k", str(K),
                      "--max-iterations", "3", "--data-shards", "1"]
            for verb in VERBS:
                path = str(work / f"{verb}.jsonl")
                if verb == "score":
                    (saved,) = os.listdir(work / "m_train")
                    argv = ["score", "--books", books, "--stop-words", stop,
                            "--model", str(work / "m_train" / saved),
                            "--output-dir", str(work / "out")]
                else:
                    algo = verb.partition(":")[2]
                    argv = ["train", *common, "--models-dir",
                            str(work / f"m_{verb.replace(':', '_')}"),
                            *(["--algorithm", algo] if algo else [])]
                rc, _, err = run(main, [*argv, "--telemetry-file", path])
                assert rc == 0, (name, verb, err[-2000:])
                out.setdefault(verb, {})[name] = jevents.read_events(path)
    yield out
    shutil.rmtree(root, ignore_errors=True)


def by_label(events, port):
    """(labels, {label: calls}, {label: signatures}, retraces) of a
    stream, the port's labels named as JAX's (``PORT_LABELS``)."""
    name = (lambda x: PORT_LABELS.get(x, x)) if port else (lambda x: x)
    snap = events[-1]["snapshot"]
    execs = {e["digest"]: name(e["label"]) for e in events
             if e["event"] == "dispatch_executable"}
    calls = {}
    for d, lbl in execs.items():
        calls[lbl] = calls.get(lbl, 0) + snap["counters"].get(
            f"dispatch.{d}.calls", 0)
    sigs = {}
    for key, v in snap["gauges"].items():
        if key.startswith("compile.") and key.endswith(".signatures"):
            sigs[name(key[len("compile."):-len(".signatures")])] = v
    return (set(execs.values()), calls, sigs,
            snap["counters"].get("compile.retraces", 0))


@pytest.mark.parametrize("verb", VERBS)
def test_labels_signatures_and_retraces_equal_jax(streams, verb):
    j = by_label(streams[verb]["jax"], port=False)
    t = by_label(streams[verb]["port"], port=True)
    assert t[0] == j[0] and t[0]
    assert t[2] == j[2]
    assert t[3] == j[3]


@pytest.mark.parametrize("verb", VERBS)
def test_calls_per_label_equal_jax(streams, verb):
    """Every label's calls, ``score.*``'s included: the CLI's default fits
    dispatch one chunk (and EM one log-likelihood), as JAX's do."""
    assert by_label(streams[verb]["port"], port=True)[1] == by_label(
        streams[verb]["jax"], port=False)[1]


@pytest.mark.parametrize("verb", VERBS)
def test_cpu_calls_carry_no_kernel_cost(streams, verb):
    """On the CPU the wrappers run their plain versions: no launch, so no
    estimate, and the announcements say so; every call's memory is its
    tensors'."""
    events = streams[verb]["port"]
    execs = [e for e in events if e["event"] == "dispatch_executable"]
    assert execs and all(
        e["cost_source"] == "none" and e["est_flops"] is None
        and e["kernels"] == {} and e["cache"] == "off"
        and e["mem_source"] == "tensors:no_kernel_library"
        and e["compile_seconds"] is None for e in execs)
    gauges = events[-1]["snapshot"]["gauges"]
    for e in execs:
        mem = {k: gauges[f"mem.{e['digest']}.{k}"] for k in (
            "arg_bytes", "out_bytes", "temp_bytes", "peak_bytes")}
        assert mem["temp_bytes"] == 0 and mem["arg_bytes"] > 0
        assert mem["peak_bytes"] == mem["arg_bytes"] + mem["out_bytes"]


# ---- each kernel's cost, by hand ----------------------------------------
def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


I32 = torch.int32


def test_emsweep_cost_hand_count():
    """k=3, shard_v=10, d_pad=8, two blocks of 4 slots: the table (120 B),
    the doc factor (96), inv_denom (12), lids (32) and the block map (8),
    8 B a live slot, the outputs 4 * 3 * (10 + 8); 8k flops a live
    slot."""
    args = (_t(3, 10), _t(3, 8), _t(3), _t(2, 1, 4, dtype=I32),
            _t(2, 1, 4, dtype=I32), _t(2, 1, 4), _t(2, dtype=I32))
    geo = dict(n_vtiles=1, nb=2, vt=16, tb=4, d_pad=8, shard_v=10,
               eta_m1=0.1)
    assert emsweep.cost(*args, **geo, live=5) == (268 + 40 + 216, 120.0)
    assert emsweep.cost(*args, **geo) == (268 + 64 + 216, 192.0)


def test_emscatter_cost_hand_count():
    """k=3 posteriors of 5 live slots (60 B), lids (32) and the block map
    (8), the [3, 10] table written (120); k adds a live slot."""
    args = (_t(8, 3), _t(2, 1, 4, dtype=I32), _t(2, dtype=I32))
    assert emscatter.cost(*args, shard_v=10, live=5) == (220, 15.0)
    assert emscatter.cost(*args, shard_v=10) == (96 + 40 + 120, 24.0)


def test_estep_cost_hand_count():
    """b=3 docs, k=2, L=5, live slots 5, 2, 0, tiles of 2 docs that ran 4
    and 7 iterations: eb of 7 live slots (56 B), cts (60), alpha (8),
    gamma0 and gamma (48); (4 * 5 + 4 * 2) iterations x slots x 9."""
    eb, cts, alpha, g0 = _t(3, 2, 5), _t(3, 5), _t(2), _t(3, 2)
    assert estep.cost(eb, cts, alpha, g0, tile_b=2, iters=[4, 7],
                      live=[5, 2, 0]) == (172, 252.0)
    assert estep.cost(eb, cts, alpha, g0, tile_b=2) == (236, 135.0)


def test_packed_cost_hand_count():
    """Two tiles of 4 token slots and d=3, k=2, live tokens 3 and 1, 4
    live slots, 5 and 2 iterations: 4 tokens x 16 B, 4 slots x 16 B,
    alpha 8 B; (5 * 3 + 2 * 1) x 9 flops."""
    args = (_t(2, 8), _t(2, 4), _t(2, 4, dtype=I32), _t(2), _t(2, 6))
    assert packed.cost(*args, 3, iters=[5, 2], live_tokens=[3, 1],
                       live_slots=4) == (136, 153.0)
    assert packed.cost(*args, 3) == (232, 72.0)


def test_nmf_cost_hand_count():
    """Two tiles of 4 tokens and d=3, k=2, 5 live tokens and 4 live
    slots: 5 x (8k + 8) + 4 x 8k + 4k^2 B; 2k x 5 + 4 x (2k^2 + 3k)
    flops."""
    args = (_t(2, 8), _t(2, 4), _t(2, 4, dtype=I32), _t(6, 2), _t(2, 2))
    assert nmf.cost(*args, 3, live_tokens=5, live_slots=4) == (200, 76.0)
    assert nmf.cost(*args, 3) == (304, 116.0)


def test_segments_cost_hand_count():
    """T=8 slots, k=2, 3 docs of 3, 2 and 0 tokens that ran 4, 6 and 1
    iterations: 5 live tokens x (k + 1) words, 4 offsets, alpha, gamma0
    and the output; (4 * 3 + 6 * 2) x (4k + 2) flops."""
    args = (_t(8, 2), _t(8), _t(4, dtype=I32), _t(2), _t(3, 2))
    assert segments.cost(*args, lens=[3, 2, 0], iters=[4, 6, 1]) == (
        132, 240.0)
    assert segments.cost(*args) == (168, 80.0)


def test_chip_smoke_bounds_read_the_costs():
    """``chip_smoke``'s bound helpers give the times of the costs above at
    the live counts their inputs hold, on the roofline's H100 row."""
    row = roofline.BACKEND_PEAKS["nvidia-h100"]
    assert (chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_FLOPS) == (
        row["bytes_per_s"], row["flops_per_s"])
    cts = torch.zeros(3, 5)
    cts[0, :5] = 1.0
    cts[1, :2] = 1.0
    assert chip_smoke.estep_bound(
        _t(3, 2, 5), cts, _t(2), _t(3, 2), torch.tensor([4, 7]), 2) == \
        chip_smoke.bound(172, 252.0)
    seg = torch.tensor([[0, 1, 2, 3], [0, 3, 3, 3]], dtype=I32)
    args = (_t(2, 8), _t(2, 4), seg, _t(2), _t(2, 6))
    assert chip_smoke.tiles_bound(torch, args, 3, torch.tensor([5, 2]),
                                  4) == chip_smoke.bound(136, 153.0)
    seg_args = (_t(8, 2), _t(8), _t(4, dtype=I32), _t(3, 2))
    assert chip_smoke.segments_bound(seg_args, _t(2), [3, 2, 0],
                                     np.array([4, 6, 1])) == \
        chip_smoke.bound(132, 240.0)


# ---- the launch, memory and disabled paths -------------------------------
@pytest.fixture
def live_registry(monkeypatch):
    """Telemetry enabled (registry only) on fresh dispatch records, the
    card's peaks for the launches' seconds, the launch counts restored."""
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(dispatch, "_peaks",
                        roofline.BACKEND_PEAKS["nvidia-h100"])
    dispatch.reset()
    telemetry.configure(None)
    yield telemetry.get_registry()
    telemetry.shutdown()
    dispatch.reset()


def test_launches_inside_a_call_are_charged_to_it(live_registry):
    """Two launches a call: their count, summed cost and the larger
    scratch are the call's; a second call adds its launches; the
    roofline row joins every call (nothing was loaded, so none is a
    compile)."""
    def two_launches(x):
        _build.count_launch("em_sweep_fused", lambda: (1000, 2000.0), 64)
        _build.count_launch("em_sweep_fused", lambda: (3000, 6000.0), 32)
        return x * 2

    f = telemetry.instrument_dispatch("em.packed_chunk", two_launches)
    x = torch.ones(4)
    f(x)
    f(x)
    (rec,) = dispatch.records().values()
    peak = roofline.BACKEND_PEAKS["nvidia-h100"]
    assert rec.kernels == {"em_sweep_fused": 4}
    assert (rec.est_bytes, rec.est_flops, rec.cost_source) == (
        4000.0, 8000.0, "kernels")
    assert rec.est_seconds == pytest.approx(4000 / peak["bytes_per_s"])
    assert rec.compile_seconds is None
    assert rec.mem_bytes["temp_bytes"] == 64
    snap = live_registry.snapshot()
    assert snap["counters"][
        f"dispatch.{rec.digest}.launches.em_sweep_fused"] == 4
    assert snap["gauges"][f"dispatch.{rec.digest}.device_bytes_total"] == \
        8000.0
    (row,) = roofline.rows_live(peak)
    assert row["available"] and row["calls"] == 2 and "warm_calls" not in row
    assert _build.LAUNCHES["em_sweep_fused"] == 4


def test_a_library_load_makes_the_first_call_a_compile(live_registry):
    def loads(x):
        dispatch.note_library_load()
        return x

    f = telemetry.instrument_dispatch("score.topic_inference", loads)
    f(torch.ones(2))
    (rec,) = dispatch.records().values()
    assert rec.compile_seconds is not None
    assert rec.compile_seconds == rec.wall_seconds
    assert live_registry.snapshot()["gauges"][
        f"compile.{rec.digest}.compile_seconds"] == rec.compile_seconds


def test_mem_bytes_are_the_calls_tensors(live_registry):
    def fn(a, pair, scale=1.0):
        return a.sum(0), (pair[0] * scale).to(torch.float64)

    a, b = torch.ones(5, 3), torch.ones(7, dtype=torch.int64)
    telemetry.instrument_dispatch("score.gather", fn)(a, (b, 3), scale=2.0)
    (rec,) = dispatch.records().values()
    assert rec.signature == "float32(5, 3)@cpu|int64(7,)@cpu|3|2.0"
    assert rec.mem_bytes == {"arg_bytes": 60 + 56, "out_bytes": 12 + 56,
                             "temp_bytes": 0, "peak_bytes": 184}
    gauges = live_registry.snapshot()["gauges"]
    assert {k: gauges[f"mem.{rec.digest}.{k}"] for k in rec.mem_bytes} == \
        rec.mem_bytes


def test_disabled_instrument_records_nothing(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    telemetry.shutdown()
    dispatch.reset()
    before = telemetry.get_registry().snapshot()

    def fn(x):
        _build.count_launch("nmf_mu_update_tiles",
                            lambda: pytest.fail("cost asked for"))
        return x + 1

    f = telemetry.instrument_dispatch("nmf.fused_chunk", fn)
    assert f.__wrapped__ is fn and f.dispatch_label == "nmf.fused_chunk"
    assert torch.equal(f(torch.zeros(2)), torch.ones(2))
    assert dispatch.records() == {}
    assert telemetry.get_registry().snapshot() == before
    assert _build.LAUNCHES["nmf_mu_update_tiles"] == 1
