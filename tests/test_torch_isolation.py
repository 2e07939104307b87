"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "spark_text_clustering_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    return mods


def test_importing_the_port_loads_no_jax():
    """Importing every module of the port and chip_smoke.py loads neither
    jax, the JAX package, nltk nor pyarrow (the card machine may lack
    it: the MLlib readers and writers import it on first use), and starts
    no process: the native text library and the CUDA kernels build on
    first use only."""
    code = (
        "import importlib, subprocess, sys\n"
        "def no_build(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = subprocess.run = no_build\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'spark_text_clustering_tpu'\n"
        "       or m.startswith('spark_text_clustering_tpu.')\n"
        "       or m == 'nltk' or m.startswith('nltk.')\n"
        "       or m == 'pyarrow' or m.startswith('pyarrow.')]\n"
        "from spark_text_clustering_tpu_torch.utils import native\n"
        "assert native._lib is None and not native._tried\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_telemetry_and_a_run_with_it_load_no_jax(tmp_path):
    """Importing the port's telemetry, and running a CLI command with
    ``--telemetry-file``, leaves jax and the JAX package out of
    ``sys.modules``; the stream the run wrote starts with its manifest
    and ends with the registry."""
    books = tmp_path / "books"
    books.mkdir()
    for i in range(3):
        (books / f"b{i}.txt").write_text(
            "The quick brown fox jumps over the lazy dog. " * (5 + i)
            + "Lorem ipsum dolor sit amet. " * (3 * i + 1))
    stream = tmp_path / "t.jsonl"
    code = (
        "import json, sys\n"
        "import spark_text_clustering_tpu_torch.telemetry\n"
        "from spark_text_clustering_tpu_torch.utils import native\n"
        "native._tried, native._error = True, 'the Python text path'\n"
        "from spark_text_clustering_tpu_torch import cli\n"
        f"rc = cli.main(['train', '--books', {str(books)!r}, '--k', '2',\n"
        "              '--max-iterations', '2', '--models-dir',\n"
        f"              {str(tmp_path / 'm')!r}, '--device', 'cpu',\n"
        f"              '--telemetry-file', {str(stream)!r}])\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
        f"lines = open({str(stream)!r}).read().splitlines()\n"
        "assert json.loads(lines[0])['event'] == 'manifest'\n"
        "assert json.loads(lines[-1])['event'] == 'registry'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]


def test_the_grid_modules_are_scanned():
    """The import and source scans cover the grid's modules: the
    ``parallel`` package, sharded evaluation, and the estimators and
    entry points that run on the grid."""
    mods = set(_port_modules())
    assert {"spark_text_clustering_tpu_torch.parallel",
            "spark_text_clustering_tpu_torch.parallel.mesh",
            "spark_text_clustering_tpu_torch.parallel.collectives",
            "spark_text_clustering_tpu_torch.models.sharded_eval",
            "spark_text_clustering_tpu_torch.models.em_lda",
            "spark_text_clustering_tpu_torch.models.online_lda",
            "spark_text_clustering_tpu_torch.models.nmf",
            "spark_text_clustering_tpu_torch.pipeline",
            "spark_text_clustering_tpu_torch.cli"} <= mods


def test_the_streaming_modules_are_scanned():
    """The import and source scans cover streaming and the resilience
    modules it brought: the ledger, retry, fault injection, the
    quarantine and the fleet supervisor."""
    mods = set(_port_modules())
    assert {"spark_text_clustering_tpu_torch.streaming",
            "spark_text_clustering_tpu_torch.resilience.ledger",
            "spark_text_clustering_tpu_torch.resilience.retry",
            "spark_text_clustering_tpu_torch.resilience.faultinject",
            "spark_text_clustering_tpu_torch.resilience.quarantine",
            "spark_text_clustering_tpu_torch.resilience.supervisor"} <= mods


def test_the_telemetry_modules_are_scanned():
    """The import and source scans cover the telemetry core and the
    dispatch layer with its readers: dispatch, the recompile sentinel,
    the roofline, the trace export, SLOs, the ``metrics`` verb, and the
    alert engine with the ``monitor`` verb."""
    mods = set(_port_modules())
    assert {f"spark_text_clustering_tpu_torch.telemetry{m}" for m in (
        "", ".registry", ".names", ".tracing", ".transport", ".prometheus",
        ".events", ".spans", ".memory", ".dispatch", ".compilation",
        ".roofline", ".trace_export", ".slo", ".metrics_cli", ".alerts",
        ".monitor_cli")} <= mods


def test_the_monitor_verb_loads_no_jax(tmp_path):
    """``monitor --once`` of a stream, with its own telemetry, an alerts
    log and an actions file, in a subprocess: it fires, and it leaves jax
    and the JAX package out of ``sys.modules`` and makes no CUDA
    context."""
    stream = str(tmp_path / "t.jsonl")
    code = (
        "import sys, torch\n"
        "torch.cuda.init = lambda: (_ for _ in ()).throw(\n"
        "    AssertionError('a CUDA context'))\n"
        "from spark_text_clustering_tpu_torch import cli, telemetry\n"
        "w = telemetry.TelemetryWriter(sys.argv[1])\n"
        "w.write_manifest(kind='storm')\n"
        "for i in range(12):\n"
        "    w.emit('dispatch_executable', digest=f'd{i}', label='x')\n"
        "w.close()\n"
        "rc = cli.main(['monitor', '--once', '--stream', sys.argv[1],\n"
        "               '--builtin', 'retrace_storm', '--fail-on-alert',\n"
        "               '--alerts-file', sys.argv[1] + '.alerts',\n"
        "               '--actions-file', sys.argv[1] + '.actions',\n"
        "               '--telemetry-file', sys.argv[1] + '.mon'])\n"
        "assert rc == 1, rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code, stream],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "fired: retrace_storm" in out.stdout


def test_the_metrics_verb_loads_no_jax(tmp_path):
    """An instrumented call's stream read back by every ``metrics``
    subcommand of the port's CLI (``scale-check`` refused with exit 2)
    leaves jax and the JAX package out of ``sys.modules``."""
    stream = str(tmp_path / "t.jsonl")
    code = (
        "import contextlib, io, sys, torch\n"
        "from spark_text_clustering_tpu_torch import cli, telemetry\n"
        f"s = {stream!r}\n"
        "telemetry.configure(s, device='cpu')\n"
        "telemetry.manifest(kind='train')\n"
        "f = telemetry.instrument_dispatch('em.packed_chunk', torch.exp)\n"
        "f(torch.ones(4)); f(torch.ones(8))\n"
        "telemetry.shutdown()\n"
        "rcs = []\n"
        "for argv in (['summarize', s], ['roofline', s], ['trace', s],\n"
        "             ['merge', s, s], ['diff', s, s], ['bench-diff', s, s],\n"
        "             ['tail', s, '--once'], ['slo', s],\n"
        "             ['scale-check', '--run']):\n"
        "    with contextlib.redirect_stdout(io.StringIO()), \\\n"
        "            contextlib.redirect_stderr(io.StringIO()):\n"
        "        rcs.append(cli.main(['metrics', *argv]))\n"
        "assert rcs[-1] == 2 and 2 not in rcs[:-1], rcs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_the_serving_modules_are_scanned():
    """The import and source scans cover the scoring service, the queueing
    estimator it prices refusals with, the per-document kernel's wrapper,
    and the serve fleet's front, probe and stream tailers."""
    mods = set(_port_modules())
    assert {"spark_text_clustering_tpu_torch.serving",
            "spark_text_clustering_tpu_torch.serving.coalescer",
            "spark_text_clustering_tpu_torch.serving.front",
            "spark_text_clustering_tpu_torch.serving.probe",
            "spark_text_clustering_tpu_torch.serving.server",
            "spark_text_clustering_tpu_torch.telemetry.alerts",
            "spark_text_clustering_tpu_torch.telemetry.queueing",
            "spark_text_clustering_tpu_torch.ops.segments"} <= mods


def test_front_and_probe_modules_load_neither_jax_nor_torch():
    """The serve fleet's front, probe and stream tailers are standard
    library only: importing them (past the package's own ``__init__``)
    loads neither torch, jax nor the JAX package, and starts no
    process."""
    code = (
        "import sys, importlib.util, subprocess, types\n"
        "def no_proc(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = subprocess.run = no_proc\n"
        "spec = importlib.util.find_spec('spark_text_clustering_tpu_torch')\n"
        "pkg = types.ModuleType(spec.name)\n"
        "pkg.__path__ = list(spec.submodule_search_locations)\n"
        "sys.modules[spec.name] = pkg\n"
        "for m in ('serving.front', 'serving.probe', 'telemetry.alerts'):\n"
        "    importlib.import_module(f'{spec.name}.{m}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_lineage_and_env_modules_load_neither_jax_nor_torch():
    """The lineage walker and the accelerator probe are host code: importing
    them (past the package's own ``__init__``) loads neither torch, jax nor
    the JAX package, and starts no process."""
    code = (
        "import sys, importlib.util, subprocess, types\n"
        "def no_proc(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = subprocess.run = no_proc\n"
        "spec = importlib.util.find_spec('spark_text_clustering_tpu_torch')\n"
        "pkg = types.ModuleType(spec.name)\n"
        "pkg.__path__ = list(spec.submodule_search_locations)\n"
        "sys.modules[spec.name] = pkg\n"
        "for m in ('lineage', 'utils.env'):\n"
        "    importlib.import_module(f'{spec.name}.{m}')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_the_lineage_verb_loads_no_jax(tmp_path):
    """``lineage`` of a model published through a ledger written on the
    CPU, by the port's CLI in a subprocess: it resolves the sources, and
    it leaves jax and the JAX package out of ``sys.modules`` and makes no
    CUDA context."""
    code = (
        "import contextlib, io, json, os, sys, numpy as np, torch\n"
        "torch.cuda.init = torch.cuda._lazy_init = lambda: (\n"
        "    _ for _ in ()).throw(AssertionError('a CUDA context'))\n"
        "from spark_text_clustering_tpu_torch import cli\n"
        "from spark_text_clustering_tpu_torch.models.base import LDAModel\n"
        "from spark_text_clustering_tpu_torch.models.persistence import (\n"
        "    save_model)\n"
        "from spark_text_clustering_tpu_torch.resilience import (\n"
        "    EpochLedger, artifact_ref)\n"
        "from spark_text_clustering_tpu_torch.telemetry import tracing\n"
        "root = sys.argv[1]\n"
        "ck, md = os.path.join(root, 'ck'), os.path.join(root, 'm')\n"
        "tracing.install(tracing.mint())\n"
        "led = EpochLedger(ck)\n"
        "led.begin(0, kind='stream-train', sources=['/w/a'], payloads=[])\n"
        "led.commit(0, kind='stream-train', sources=['/w/a'])\n"
        "save_model(LDAModel(lam=np.ones((2, 4), np.float32),\n"
        "                    vocab=list('abcd'),\n"
        "                    alpha=np.ones(2, np.float32),\n"
        "                    eta=0.1, device='cpu'), md,\n"
        "           ledger_ref={'dir': ck, 'epoch': 1})\n"
        "led.begin(1, kind='model-publish', sources=[], payloads=[])\n"
        "led.commit(1, kind='model-publish', sources=[],\n"
        "           model_ref=artifact_ref(md))\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = cli.main(['lineage', md, '--json'])\n"
        "rep = json.loads(out.getvalue())\n"
        "assert rc == 0 and rep['sources'] == ['/w/a'], rep\n"
        "assert rep['lineage'] == 'resolved' and not rep['degraded'], rep\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_compilecache_loads_neither_jax_nor_torch(tmp_path):
    """The compile cache's store is host code: importing it (past the
    package's own ``__init__``) and listing a store loads neither torch,
    jax nor the JAX package, and starts no process."""
    code = (
        "import sys, importlib.util, subprocess, types\n"
        "def no_proc(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = subprocess.run = no_proc\n"
        "spec = importlib.util.find_spec('spark_text_clustering_tpu_torch')\n"
        "pkg = types.ModuleType(spec.name)\n"
        "pkg.__path__ = list(spec.submodule_search_locations)\n"
        "sys.modules[spec.name] = pkg\n"
        "cc = importlib.import_module(f'{spec.name}.compilecache')\n"
        "store = cc.configure(sys.argv[1])\n"
        "assert cc.active() and store.entries() == [] and store.gc(1) == {\n"
        "    'entries': 0, 'stages': 0, 'quarantined': 0}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "cc")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_the_compile_cache_ls_verb_loads_no_jax(tmp_path):
    """``compile-cache ls`` of a store holding an entry, by the port's CLI
    in a subprocess: it lists the entry, and it leaves jax and the JAX
    package out of ``sys.modules`` and makes no CUDA context."""
    code = (
        "import contextlib, io, json, os, sys, torch\n"
        "torch.cuda.init = torch.cuda._lazy_init = lambda: (\n"
        "    _ for _ in ()).throw(AssertionError('a CUDA context'))\n"
        "from spark_text_clustering_tpu_torch import cli\n"
        "from spark_text_clustering_tpu_torch.resilience.integrity import (\n"
        "    finalize_artifact_dir)\n"
        "entry = os.path.join(sys.argv[1], 'nvcc12.4-sm_90a-x-0', 'd0')\n"
        "os.makedirs(entry)\n"
        "open(os.path.join(entry, 'estep.so'), 'wb').write(b'x' * 64)\n"
        "json.dump({'label': 'estep', 'payload_bytes': 64, 'created_at': 1.0},\n"
        "          open(os.path.join(entry, 'entry.json'), 'w'))\n"
        "finalize_artifact_dir(entry)\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = cli.main(['compile-cache', 'ls', '--json', '--cache-dir',\n"
        "                   sys.argv[1]])\n"
        "(e,) = json.loads(out.getvalue())['entries']\n"
        "assert rc == 0 and e['label'] == 'estep', e\n"
        "assert e['status'] == 'committed', e\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "cc")],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_the_lint_verb_loads_no_jax(tmp_path):
    """Importing ``analysis`` and running ``lint --no-jaxpr --protocol
    --format json`` over the port's tree by the port's CLI in a
    subprocess: exit 0 with no unwaived and no stale findings, and it
    leaves jax and the JAX package out of ``sys.modules``, makes no CUDA
    context and loads no kernel library."""
    code = (
        "import contextlib, io, json, sys, torch\n"
        "torch.cuda.init = torch.cuda._lazy_init = lambda: (\n"
        "    _ for _ in ()).throw(AssertionError('a CUDA context'))\n"
        "import spark_text_clustering_tpu_torch.analysis\n"
        "from spark_text_clustering_tpu_torch import cli\n"
        "from spark_text_clustering_tpu_torch.ops import _build\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = cli.main(['lint', '--no-jaxpr', '--protocol', '--format',\n"
        "                   'json'])\n"
        "doc = json.loads(out.getvalue())\n"
        "assert rc == 0 and doc['counts']['findings'] == 0, doc['findings']\n"
        "assert doc['protocol']['rules'] == {f'STC30{i}': 0 for i in range(6)}\n"
        "assert not [f for f in doc['findings'] if f['rule'] == 'STC000']\n"
        "assert doc['counts']['waived'] > 0\n"
        "assert not torch.cuda.is_initialized() and not _build._LIBS\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_front_and_probe_run_without_a_cuda_context(tmp_path, monkeypatch):
    """The ``front`` and ``probe`` verbs never touch the card: with every
    way to a CUDA context made to raise, the front serves a request (503:
    no replica) and drains, and the probe probes a front."""
    import http.client
    import json
    import threading

    from spark_text_clustering_tpu_torch import cli

    def no_card(*a, **k):
        raise AssertionError("a CUDA context was asked for")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_card)
    monkeypatch.setattr(torch.cuda, "init", no_card)
    monkeypatch.setattr(cli, "resolve_device", no_card)
    fleet = str(tmp_path / "fleet")
    got = {}

    def client():
        front = os.path.join(fleet, "front.json")
        deadline = time.monotonic() + 30
        while not os.path.exists(front) and time.monotonic() < deadline:
            time.sleep(0.02)
        with open(front) as f:
            port = json.load(f)["port"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/score", body=b'{"text": "x"}')
        got["status"] = conn.getresponse().status
        conn.close()
        got["probe"] = cli.main(["probe", "--url", f"http://127.0.0.1:{port}",
                                 "--count", "1", "--rate", "50",
                                 "--timeout", "5"])

    t = threading.Thread(target=client)
    t.start()
    rc = cli.main(["front", "--fleet-dir", fleet, "--port", "0",
                   "--wait-for-replica", "0.1", "--max-seconds", "3"])
    t.join(30)
    assert rc == 0 and got == {"status": 503, "probe": 0}
    assert not torch.cuda.is_initialized()


def test_supervised_serve_replicas_resolve_the_card(tmp_path, monkeypatch):
    """A ``serve`` replica that ``supervise --role serve`` starts without
    ``--device`` asks for the card: its argv carries no device, parses to
    cuda, and the replica resolves cuda before anything else (a stub
    raises on a CPU fallback)."""
    from spark_text_clustering_tpu_torch import cli

    class Card(Exception):
        pass

    def resolve(device="cuda"):
        if torch.device(device).type != "cuda":
            raise AssertionError(f"the replica fell back to {device}")
        raise Card(device)

    args = cli.build_parser().parse_args(
        ["supervise", "--role", "serve", "--fleet-dir",
         str(tmp_path / "fleet")])
    argv = cli._serve_replica_argv(args, 0, 2, 0, 0)
    assert argv[2:4] == ["spark_text_clustering_tpu_torch.cli", "serve"]
    assert "--device" not in argv
    rargs = cli.build_parser().parse_args(argv[3:])
    assert rargs.device == "cuda"
    monkeypatch.setattr(cli, "resolve_device", resolve)
    with pytest.raises(Card, match="cuda"):
        rargs.fn(rargs)
    assert not os.path.exists(tmp_path / "fleet")


def test_a_scoring_service_loads_no_jax(tmp_path):
    """A port scoring service on the CPU, over HTTP (load, warmup, one
    POST, drain), leaves jax and the JAX package out of ``sys.modules``."""
    code = (
        "import json, sys, threading, urllib.request\n"
        "import numpy as np\n"
        "from spark_text_clustering_tpu_torch.utils import native\n"
        "native._tried, native._error = True, 'the Python text path'\n"
        "from spark_text_clustering_tpu_torch.interop import "
        "lda_model_from_numpy\n"
        "from spark_text_clustering_tpu_torch.serving import (\n"
        "    ScoringService, make_http_server)\n"
        "vocab = ['alpha', 'beta', 'gamma', 'delta']\n"
        "m = lda_model_from_numpy(np.arange(1, 13).reshape(3, 4), 0.5, 1.1,\n"
        "                         vocab, device='cpu')\n"
        f"m.save({str(tmp_path / 'm' / 'LdaModel_EN_1000')!r})\n"
        f"svc = ScoringService({str(tmp_path / 'm')!r}, 'EN', max_batch=4,\n"
        "                     token_buckets=(64,), lemmatize=False,\n"
        "                     watch_model=False, device='cpu')\n"
        "httpd = make_http_server(svc, port=0)\n"
        "threading.Thread(target=httpd.serve_forever, daemon=True).start()\n"
        "req = urllib.request.Request(\n"
        "    f'http://127.0.0.1:{httpd.server_address[1]}/score',\n"
        "    data=json.dumps({'text': 'alpha beta beta delta'}).encode())\n"
        "doc = json.loads(urllib.request.urlopen(req, timeout=30).read())\n"
        "assert len(doc['results'][0]['distribution']) == 3, doc\n"
        "svc.begin_drain(); httpd.shutdown(); httpd.server_close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b"
    r"|import\s+spark_text_clustering_tpu(\.|\s|$)"
    r"|from\s+spark_text_clustering_tpu(\.|\s))",
    re.M,
)


def test_source_scan_finds_no_jax_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for m in _FORBIDDEN.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)}")
    assert not hits, hits


def test_grid_stream_worker_and_path_load_no_jax():
    """The grid stream tests' rank module holds no jax import, and a 1x2
    grid stream run through it (``run_grid``, the trainer on both ranks,
    rank 0 sharing the micro-batches) loads neither jax nor the JAX
    package, in the ranks or in the process that spawned them."""
    path = os.path.join(REPO, "tests", "torch_grid_stream_worker.py")
    with open(path, encoding="utf-8") as f:
        assert not _FORBIDDEN.findall(f.read())
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import torch_grid_stream_worker as w\n"
        "from spark_text_clustering_tpu_torch.parallel import run_grid\n"
        "from spark_text_clustering_tpu_torch.streaming import MicroBatch\n"
        "spec = {'k': 2, 'seed': 0, 'capacity': 4, 'checkpoint_every': 1,\n"
        "        'v': 64, 'batches': [MicroBatch(b, [f'd{b}{i}' for i in\n"
        "        range(4)], ['alpha beta gamma delta.'] * 4)\n"
        "        for b in range(2)]}\n"
        "out = run_grid(w.loaded_jax, 1, 2, (spec,), backend='gloo',\n"
        "               device='cpu', timeout=120)\n"
        "here = [m for m in sys.modules\n"
        "        if m.split('.')[0] in ('jax', 'spark_text_clustering_tpu')]\n"
        "assert out == [[], []] and not here, (out, here)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]


def test_entry_points_default_to_the_card():
    """With no card, the default device raises; device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from spark_text_clustering_tpu_torch import EMLDA, IDF, Params
    from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy

    with pytest.raises(RuntimeError, match="device='cpu'"):
        EMLDA(Params(k=3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IDF().fit({"rows": [], "vocab": ["a"]})
    model = lda_model_from_numpy(np.ones((3, 4)), 1.0, 1.1, list("abcd"))
    rows = [(np.array([0, 2], np.int32), np.array([1.0, 2.0], np.float32))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.topic_distribution(rows)
    dist = model.topic_distribution(rows, device="cpu")
    assert dist.shape == (1, 3)
    rows = [(np.array([0, 1, 3], np.int32), np.ones(3, np.float32))] * 3
    m = EMLDA(Params(k=3, max_iterations=2), device="cpu").fit(
        rows, list("abcd"))
    assert m.lam.shape == (3, 4) and np.isfinite(m.lam).all()


def test_online_entry_points_default_to_the_card():
    """The online slice's entry points take the card by default too: the
    estimator, the facade, and the model's evaluation raise without one;
    device='cpu' (and rng_device='cpu') runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from spark_text_clustering_tpu_torch import LDA, OnlineLDA, Params
    from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy

    params = Params(k=2, algorithm="online", sampling="epoch",
                    token_layout="tiles", max_iterations=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineLDA(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineLDA(params, device="cpu", rng_device="cuda")
    rows = [(np.array([0, 1, 3], np.int32), np.ones(3, np.float32))] * 4
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LDA(params).fit({"rows": rows, "vocab": list("abcd")})
    model = lda_model_from_numpy(np.ones((2, 4)), 0.5, 0.5, list("abcd"),
                                 algorithm="online")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.log_perplexity(rows)
    assert np.isfinite(model.log_perplexity(rows, device="cpu"))
    m = OnlineLDA(params, device="cpu", rng_device="cpu").fit(
        rows, list("abcd"))
    assert m.lam.shape == (2, 4) and np.isfinite(m.lam).all()


def test_nmf_entry_points_default_to_the_card():
    """The NMF slice's entry points take the card by default too: the
    estimator, the model's transform and the "nmf" facade raise without
    one; device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from spark_text_clustering_tpu_torch import (
        LDA, NMF, NMFEstimator, Params,
    )
    from spark_text_clustering_tpu_torch.interop import nmf_model_from_numpy

    params = Params(k=2, algorithm="nmf", max_iterations=2)
    rows = [(np.array([0, 1, 3], np.int32), np.ones(3, np.float32))] * 4
    ds = {"rows": rows, "vocab": list("abcd")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NMF(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NMF(params, device="cpu", rng_device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LDA(params).fit(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NMFEstimator(params).fit(ds)
    model = nmf_model_from_numpy(np.ones((2, 4)), list("abcd"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.transform(rows)
    assert model.transform(rows, device="cpu").shape == (4, 2)
    m = NMF(params, device="cpu").fit(rows, list("abcd"))
    assert m.h.shape == (2, 4) and np.isfinite(m.h).all()
    assert LDA(params, device="cpu").fit(ds).model.device == "cpu"


def test_cli_defaults_to_the_card(tmp_path):
    """Without a card and without --device cpu, the CLI's train and score
    raise as every entry point of the port does, before reading a book."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from spark_text_clustering_tpu_torch import cli

    for argv in (["score", "--books", str(tmp_path / "none"),
                  "--models-dir", str(tmp_path)],
                 ["train", "--books", str(tmp_path / "none")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert cli.main(["score", "--books", str(tmp_path), "--models-dir",
                     str(tmp_path), "--device", "cpu"]) == 2


def test_stream_verbs_default_to_the_card(tmp_path):
    """Without a card and without --device cpu, stream-score and
    stream-train raise before reading a file or touching the watch dir;
    the streaming trainer does too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from spark_text_clustering_tpu_torch import Params, cli
    from spark_text_clustering_tpu_torch.streaming import StreamingOnlineLDA

    watch = str(tmp_path / "watch")
    for argv in (["stream-score", "--watch-dir", watch, "--models-dir",
                  str(tmp_path)],
                 ["stream-train", "--watch-dir", watch, "--checkpoint-dir",
                  str(tmp_path / "ck")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingOnlineLDA(Params(k=2), num_features=8)
    assert cli.main(["stream-score", "--watch-dir", watch, "--models-dir",
                     str(tmp_path), "--device", "cpu"]) == 2


def test_supervisor_imports_neither_torch_nor_jax():
    """The fleet supervisor is subprocess-and-files machinery that must
    survive whatever a worker does to the card: importing it (and the
    resilience layer under it) loads neither torch, jax nor the JAX
    package, and running a fleet of workers that import nothing keeps it
    so."""
    code = (
        "import sys, importlib.util, types\n"
        "spec = importlib.util.find_spec('spark_text_clustering_tpu_torch')\n"
        "pkg = types.ModuleType(spec.name)\n"
        "pkg.__path__ = list(spec.submodule_search_locations)\n"
        "sys.modules[spec.name] = pkg\n"
        "from spark_text_clustering_tpu_torch.resilience import supervisor\n"
        "import tempfile, os\n"
        "d = tempfile.mkdtemp()\n"
        "def argv(i, n, g, s):\n"
        "    lease = supervisor.lease_path(d, i)\n"
        "    return [sys.executable, '-c', 'import json, os, sys; '\n"
        "            'json.dump({\"spawn_id\": %d, \"done\": True, '\n"
        "            '\"ts\": 0}, open(sys.argv[1], \"w\"))' % s, lease]\n"
        "rep = supervisor.FleetSupervisor(d, argv, workers=2,\n"
        "                                 sweep_interval=0.05).run()\n"
        "assert rep.converged and rep.spawns == 2, rep\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'numpy', 'spark_text_clustering_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _worker_argv(argv, index=1, count=3, generation=2, spawn_id=7):
    from spark_text_clustering_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["supervise", "--watch-dir", "w", "--fleet-dir", "f", *argv])
    return cli._worker_argv(args, index, count, generation, spawn_id)


@pytest.mark.parametrize("role", ["stream-score", "stream-train"])
def test_supervise_workers_run_the_ports_cli(role):
    """``supervise`` starts each worker as the port's CLI, never the JAX
    package's, with its fleet identity and its own checkpoint dir."""
    from spark_text_clustering_tpu_torch import cli

    argv = _worker_argv(["--role", role])
    assert argv[:4] == [sys.executable, "-m",
                        "spark_text_clustering_tpu_torch.cli", role]
    args = cli.build_parser().parse_args(argv[3:])
    assert (args.fleet_dir, args.worker_index, args.worker_count,
            args.fleet_generation, args.fleet_spawn_id) == ("f", 1, 3, 2, 7)
    assert args.checkpoint_dir == os.path.join("f", "w001")


@pytest.mark.parametrize("device,want", [(None, "cuda"), ("cpu", "cpu"),
                                         ("cuda:0", "cuda:0")])
def test_supervise_workers_default_to_the_card(device, want):
    """Without --device, ``supervise`` passes none, so every worker runs on
    the card as the stream verbs do; a --device given is passed on."""
    from spark_text_clustering_tpu_torch import cli

    for role in ("stream-score", "stream-train"):
        extra = [] if device is None else ["--device", device]
        argv = _worker_argv(["--role", role, *extra])
        assert ("--device" in argv) == (device is not None)
        assert cli.build_parser().parse_args(argv[3:]).device == want


def test_supervise_defaults_to_the_card(tmp_path):
    """Without a card and without --device cpu, ``supervise`` raises
    before it writes a fleet record or starts a worker."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from spark_text_clustering_tpu_torch import cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["supervise", "--watch-dir", str(tmp_path / "w"),
                  "--fleet-dir", str(tmp_path / "f")])
    assert os.listdir(tmp_path) == []


def test_resolving_cuda_turns_tf32_off(monkeypatch):
    from spark_text_clustering_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device().type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository, the script fails and prints no result."""
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
