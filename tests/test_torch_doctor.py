"""The port's ``doctor`` verb and its accelerator probe against the JAX
package's, on the CPU.

``doctor`` probes the card only in a throwaway subprocess: its own process
makes no CUDA context (every way to one raises here), builds no CUDA
kernel library and writes nothing in its working directory; where torch
sees no CUDA device the report says ``NONE``.  A probe
that hangs comes back as ``hang`` within its timeout.  With
``subprocess.run`` answering both packages' probes with the same canned
results, ``utils.env.probe_accelerator`` returns the JAX package's dict,
history and counters.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import time

import pytest
import torch

from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.resilience import retry as jretry
from spark_text_clustering_tpu.utils import env as jenv
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.ops import _build
from spark_text_clustering_tpu_torch.resilience import retry as tretry
from spark_text_clustering_tpu_torch.utils import env as tenv

# what the port's probe says beyond the JAX package's keys
DETAIL = ("cuda", "name", "capability", "gloo")
OUTCOMES = ("ok", "hang", "init_error", "cpu_fallback")


@pytest.fixture(autouse=True)
def _clean():
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()
    yield
    for tel in (telemetry, jtelemetry):
        tel.shutdown()
        tel.get_registry().reset()


def _no_card(*a, **k):
    raise AssertionError("a CUDA context was asked for")


def _built():
    return sorted(p.name for p in _build.BUILD_DIR.glob("*.so")) \
        if _build.BUILD_DIR.exists() else []


def test_doctor_reports_every_line_without_a_cuda_context(tmp_path,
                                                          monkeypatch):
    """Exit 0 with the title and the four report lines; no CUDA context in
    this process, no kernel library built, nothing written in the cwd."""
    monkeypatch.setattr(torch.cuda, "init", _no_card)
    monkeypatch.setattr(torch.cuda, "_lazy_init", _no_card)
    monkeypatch.chdir(tmp_path)
    before = _built()
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["doctor", "--probe-timeout", "45"])
    assert rc == 0 and time.monotonic() - t0 < 45 + 120
    lines = out.getvalue().splitlines()
    assert lines[0] == "spark_text_clustering_tpu_torch doctor"
    assert lines[1].startswith(
        f"  accelerator: OK — torch {torch.__version__}, cuda "
        if torch.cuda.is_available() else
        f"  accelerator: NONE — torch {torch.__version__} sees no CUDA "
        "device (0 device(s))")
    assert lines[2] == "  cpu path (--device cpu, gloo): OK"
    assert lines[3] in ("  native textproc (C++ ctypes): OK",
                        "  native textproc (C++ ctypes): unavailable — "
                        "Python path")
    assert lines[4].startswith("  kernels (nvcc, sm_90a): ")
    assert (f"/{len(_build.SOURCES)} libraries built for "
            f"{_build._digest()} in {_build.BUILD_DIR}") in lines[4]
    assert len(lines) == 5
    assert not torch.cuda.is_initialized()
    assert os.listdir(tmp_path) == []
    made = set(_built()) - set(before)
    assert not {n for n in made if n.rsplit("_", 1)[0] in _build.SOURCES}


def test_doctor_kernel_line_counts_the_built_libraries(tmp_path,
                                                       monkeypatch):
    """The kernels line names nvcc with its release and counts the
    libraries built for the current sources' and toolchain's digest (a
    stale digest's, or another nvcc release's, do not count), reading
    only."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'nvcc: NVIDIA (R) Cuda compiler'\n"
                    "echo 'Cuda compilation tools, release 12.4, "
                    "V12.4.131'\n")
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for name in _build.SOURCES[:4]:
        _build._lib_path(name).touch()
    (build / f"{_build.SOURCES[4]}_0123456789abcdef.so").touch()
    listing = sorted(os.listdir(build))
    line = tcli._kernel_toolchain()
    assert line == (f"{nvcc} (12.4, V12.4.131), 4/{len(_build.SOURCES)} "
                    f"libraries built for {_build._digest()} in {build}")
    _build._lib_path(_build.SOURCES[4]).touch()
    _build._lib_path(_build.SOURCES[5]).touch()
    assert "6/6 libraries" in tcli._kernel_toolchain()
    digest = _build._digest()

    # another release of nvcc names other libraries
    nvcc2 = tmp_path / "nvcc2"
    nvcc2.write_text(nvcc.read_text().replace("12.4", "12.6"))
    nvcc2.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc2))
    assert _build._digest() != digest
    assert tcli._kernel_toolchain().startswith(f"{nvcc2} (12.6, V12.6.131), "
                                               "0/6")

    def missing():
        raise _build.KernelError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", missing)
    assert _build._digest() != digest
    assert tcli._kernel_toolchain().startswith("nvcc missing, 0/6")
    assert sorted(os.listdir(build)) == sorted(
        listing + [f"{_build.SOURCES[4]}_{digest}.so",
                   f"{_build.SOURCES[5]}_{digest}.so"])


def test_hanging_probe_returns_hang_within_its_timeout(tmp_path):
    """A probe interpreter that hangs (a ``sitecustomize`` that sleeps
    past the timeout) comes back as ``hang`` within the timeout plus
    slack, in both packages alike."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text("import time\ntime.sleep(120)\n")
    env = {**os.environ, "PYTHONPATH": str(site)}
    got = {}
    for name, mod in (("torch", tenv), ("jax", jenv)):
        t0 = time.monotonic()
        got[name] = mod.probe_accelerator(attempts=1, probe_timeout=2,
                                          env=env)
        assert time.monotonic() - t0 < 2 + 20
    rep = got["torch"]
    assert rep["ok"] is False and rep["error"] == "probe hung >2s"
    assert [h["outcome"] for h in rep["history"]] == ["hang"]
    assert _without_clock(rep) == _without_clock(got["jax"])


def _without_clock(rep):
    """``rep`` without its history's ``utc`` and ``elapsed_s`` and without
    the port's own keys."""
    out = {k: v for k, v in rep.items() if k not in DETAIL}
    out["history"] = [{k: v for k, v in row.items()
                       if k not in ("utc", "elapsed_s")}
                      for row in rep["history"]]
    return out


# canned answers of the probe interpreter: (returncode, stdout, stderr),
# or None for one that outlived its timeout
CANNED = {
    "hang": [None, None],
    "init_error": [(1, "", "Traceback ...\nRuntimeError: no CUDA runtime\n")] * 2,
    "no_line": [(0, "nothing\n", "")] * 2,
    "cpu": [(0, 'PROBE {"v": "2.5.1", "b": "cpu", "n": 0}\n', "")] * 2,
    "ok": [(0, 'PROBE {"v": "2.5.1", "b": "cuda", "n": 1}\n', "")],
    "hang_then_ok": [None, (0, 'PROBE {"v": "2.5.1", "b": "cuda", '
                               '"n": 1, "cuda": "12.4", "name": '
                               '"NVIDIA H100 80GB HBM3", "capability": '
                               '[9, 0], "gloo": true}\n', "")],
}


@pytest.mark.parametrize("require", [True, False])
@pytest.mark.parametrize("case", sorted(CANNED))
def test_probe_matches_jax_on_canned_results(monkeypatch, case, require):
    """The same canned answers give the JAX package's result dict, history
    rows, backoff waits and ``probe.accelerator.<outcome>`` counters; the
    port's words for "no CUDA device" are its own."""
    def run_both(mod, retry, tel):
        answers = list(CANNED[case])
        waits = []

        def fake_run(argv, timeout=None, **kw):
            assert argv[0] == sys.executable and argv[1] == "-c"
            ans = answers.pop(0)
            if ans is None:
                raise subprocess.TimeoutExpired(argv, timeout)
            return subprocess.CompletedProcess(argv, *ans)

        monkeypatch.setattr(subprocess, "run", fake_run)
        monkeypatch.setattr(retry, "sleep", waits.append)
        tel.configure(None)
        rep = mod.probe_accelerator(attempts=2, probe_timeout=7,
                                    require_accelerator=require)
        counters = {o: tel.get_registry().counter(
            f"probe.accelerator.{o}").value for o in OUTCOMES}
        tel.shutdown()
        return rep, waits, counters

    port, port_waits, port_counts = run_both(tenv, tretry, telemetry)
    jax, jax_waits, jax_counts = run_both(jenv, jretry, jtelemetry)
    assert port_waits == jax_waits and port_counts == jax_counts
    want = _without_clock(jax)
    if case == "cpu" and require:
        # the JAX package names its own platform in the message
        assert want["error"] == "jax fell back to the cpu platform"
        want["error"] = "torch sees no CUDA device"
        for row in want["history"]:
            row["error"] = "torch sees no CUDA device"
    assert _without_clock(port) == want
    if case == "hang_then_ok":
        assert {k: port[k] for k in DETAIL} == {
            "cuda": "12.4", "name": "NVIDIA H100 80GB HBM3",
            "capability": [9, 0], "gloo": True}
        assert port_waits == [0.0, 10.0]


def test_scrubbed_cpu_env_hides_the_card():
    env = tenv.scrubbed_cpu_env({"PATH": "/bin", "CUDA_VISIBLE_DEVICES": "0"})
    assert env == {"PATH": "/bin", "CUDA_VISIBLE_DEVICES": ""}
    assert tenv.scrubbed_cpu_env()["CUDA_VISIBLE_DEVICES"] == ""


def test_doctor_flags_and_defaults_match_jax():
    """``doctor`` takes the JAX CLI's one flag with its default."""
    def verb(parser):
        (sub,) = [a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction)]
        return {(tuple(a.option_strings), a.default, a.type)
                for a in sub.choices["doctor"]._actions}

    assert verb(tcli.build_parser()) == verb(jcli.build_parser())
