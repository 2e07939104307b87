#!/usr/bin/env python3
"""The PyTorch port's main path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--profile] [--out DIR] [--kernels-only]

1. builds the three CUDA kernels from ``spark_text_clustering_tpu_torch/
   csrc`` (one ``nvcc`` per source, in parallel, into build/torch_kernels);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times kernel, plain version, and
   (for the scatter) the one PyTorch call that computes the same function,
   and asks the fused gate for geometries its shared memory refuses;
3. config A, the EN books shape: 51 docs of 2,000-20,000 distinct terms,
   V=39,380, k=5.  IDF -> EM fit (fused sweep, resumed from one random
   start) -> save -> load -> padded-bucket scoring -> scoring report.  The
   fit is re-run with device="cpu" (the plain versions) from the same
   start; the average log-likelihoods must agree within 1e-4;
4. config B, the 20 Newsgroups shape: 11,314 docs, V=2^18 hashed Zipf
   terms, k=20.  IDF -> EM fit (two-stage sweep: 11,314 docs > 512) ->
   save -> load -> scoring of every doc;
5. a ``kernels`` line: per kernel, the launches of the main-path runs of
   3 and 4 (each must be > 0), the largest difference from the plain
   version, and the times beside the card's bound.

Every phase prints one JSON line; the first line is ``nvidia-smi``'s name
and power limit, and the last is ``{"ok": true, "device": {...}}``.  Any
failure raises: nothing falls back to the CPU.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.  Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores

EN_DOCS, EN_V, EN_K = 51, 39_380, 5
NG_DOCS, NG_V, NG_K = 11_314, 1 << 18, 20
SWEEPS = 50                    # MLlib's maxIterations for both configs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---- corpora: the two shapes of bench.py, made from the seed -------------
def en_books_rows(seed: int):
    """EN-shaped corpus: 51 books of 2,000-20,000 distinct terms."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(EN_DOCS):
        nnz = int(rng.integers(2000, 20000))
        ids = np.sort(rng.choice(EN_V, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, rng.integers(1, 50, nnz).astype(np.float32)))
    return rows


def newsgroups_rows(seed: int):
    """20NG-shaped corpus: Zipf-distributed hashed ids, ~110 distinct
    terms per doc."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(NG_V)
    rows = []
    for _ in range(NG_DOCS):
        nnz = min(max(4, int(rng.lognormal(mean=4.4, sigma=0.8))), 2048)
        ranks = rng.zipf(1.3, size=nnz * 2) - 1
        ranks = ranks[ranks < NG_V][:nnz]
        ids = np.unique(perm[ranks]).astype(np.int32)
        rows.append((ids, rng.integers(1, 6, size=ids.size).astype(np.float32)))
    return rows


# ---- timing ----------------------------------------------------------------
def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- phase 2: each kernel against its plain version ------------------------
def sorted_layout(torch, rows, v, dev):
    """The fit's packed, vocab-sorted token layout for ``rows``."""
    from spark_text_clustering_tpu_torch.models.em_lda import packed_plan
    from spark_text_clustering_tpu_torch.ops.emscatter import plan_em_scatter

    ids, cts, seg, _, d_max = packed_plan(rows)
    plan = plan_em_scatter(ids[None], cts[None], 1, v)
    so = plan.sort_order[0]

    def srt(a):
        return torch.from_numpy(np.concatenate([a, a[:1] * 0])[so]).to(dev)

    return plan, srt(ids), srt(cts), srt(seg), d_max


def check_sweep(torch, rows, dev, rng):
    from spark_text_clustering_tpu_torch.ops import emsweep

    k, v = EN_K, EN_V
    plan, ids_s, cts_s, seg_s, d_max = sorted_layout(torch, rows, v, dev)
    d_pad = emsweep.fused_d_pad(d_max)
    alpha, eta = 50.0 / k + 1.0, 1.1
    n_wk = torch.from_numpy(rng.gamma(1.0, 20.0, (k, v)).astype(np.float32)).to(dev)
    n_dk = torch.from_numpy(rng.gamma(1.0, 2000.0, (d_max, k)).astype(np.float32)).to(dev)
    inv_denom = 1.0 / (n_wk.sum(1) + (eta * v - v))
    docf = torch.zeros((k, d_pad), device=dev)
    docf[:, :d_max] = (n_dk + (alpha - 1.0)).T
    blk = (plan.nb, 1, plan.tb)
    args = (n_wk, docf, inv_denom, torch.from_numpy(plan.lids[0, 0]).to(dev),
            seg_s.reshape(blk), cts_s.reshape(blk),
            torch.from_numpy(plan.block_vtile[0, 0]).to(dev))
    geo = dict(n_vtiles=plan.n_vtiles, vt=plan.vt, tb=plan.tb, d_pad=d_pad,
               shard_v=v, eta_m1=eta - 1.0)
    # the gate's shared-memory half, asked of the kernel: config A fits;
    # k=500 and k=40 at 512 docs do not
    gate = {f"d{d}_k{kk}": emsweep.fused_eligible(d, kk, dev)
            for d, kk in ((d_max, k), (8, 500), (512, 40))}
    if gate != {f"d{d_max}_k{k}": True, "d8_k500": False, "d512_k40": False}:
        raise AssertionError(f"fused gate on the card: {gate}")
    got = emsweep.em_sweep_fused(*args, nb=plan.nb, **geo)
    want = emsweep.em_sweep_fused_plain(*args, **geo)
    torch.cuda.synchronize()
    err = rel = 0.0
    for g, w in zip(got, want):
        err = max(err, float((g - w).abs().max()))
        rel = max(rel, float(((g - w).abs() / w.abs().clamp(min=1.0)).max()))
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-5):
            raise AssertionError(
                f"em_sweep_fused differs from its plain version by {err}")
    again = emsweep.em_sweep_fused(*args, nb=plan.nb, **geo)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    # bytes the kernel needs: the table, the doc factor, every slot's lid
    # and block map, seg and cts of live slots only, and the two outputs
    live = int((cts_s > 0).sum())
    t_bytes, by = bound(
        nbytes(n_wk, docf, inv_denom, args[3], args[6]) + 8 * live
        + nbytes(*got), 8.0 * k * live)
    return {
        "name": "em_sweep_fused", "route": "cuda",
        "source": "spark_text_clustering_tpu_torch/csrc/emsweep.cu",
        "replaces": "spark_text_clustering_tpu/ops/pallas_emsweep.py:203",
        "shape": {"k": k, "shard_v": v, "tokens": live, "nb": plan.nb,
                  "d_pad": d_pad},
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": "rtol 1e-4, atol 1e-5",
        "bitwise_repeatable": deterministic, "gate": gate,
        "ms": cuda_ms(torch, lambda: emsweep.em_sweep_fused(
            *args, nb=plan.nb, **geo), 20),
        "plain_ms": cuda_ms(torch, lambda: emsweep.em_sweep_fused_plain(
            *args, **geo), 5),
        "bound_ms": t_bytes, "bound_by": by, "library_ms": None,
    }


def check_scatter(torch, rows, dev, rng):
    from spark_text_clustering_tpu_torch.ops import emscatter

    k, v = NG_K, NG_V
    plan, ids_s, cts_s, _, _ = sorted_layout(torch, rows, v, dev)
    t = ids_s.shape[0]
    phi = torch.from_numpy(rng.exponential(size=(t, k)).astype(np.float32)).to(dev)
    wphi = (cts_s[:, None] * phi / phi.sum(1, keepdim=True)).contiguous()
    lids = torch.from_numpy(plan.lids[0, 0]).to(dev)
    bv = torch.from_numpy(plan.block_vtile[0, 0]).to(dev)
    geo = dict(n_vtiles=plan.n_vtiles, vt=plan.vt, tb=plan.tb, shard_v=v)
    got = emscatter.scatter_add_vtiles(wphi, lids, bv, nb=plan.nb, **geo)
    want = emscatter.scatter_add_vtiles_plain(wphi, lids, bv, **geo)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"scatter_add_vtiles differs from its plain version by {err}")
    again = emscatter.scatter_add_vtiles(wphi, lids, bv, nb=plan.nb, **geo)
    ids_l = ids_s.long()

    def library():
        return torch.zeros((k, v), device=dev).index_add_(1, ids_l, wphi.T)

    lib_err = float((library() - got).abs().max())
    # bytes the kernel needs: k posteriors of each live slot (it skips pad
    # slots), every slot's lid, the block map, and the table it writes
    live = int((cts_s > 0).sum())
    t_bytes, by = bound(4 * k * live + nbytes(lids, bv, got), float(k * live))
    return {
        "name": "scatter_add_vtiles", "route": "cuda",
        "source": "spark_text_clustering_tpu_torch/csrc/emscatter.cu",
        "replaces": "spark_text_clustering_tpu/ops/pallas_emscatter.py:236",
        "shape": {"k": k, "shard_v": v, "tokens": live, "nb": plan.nb},
        "max_abs_err": err, "max_rel_err": rel,
        "library_max_abs_err": lib_err,
        "tolerance": "rtol 1e-5, atol 1e-5",
        "bitwise_repeatable": bool(torch.equal(got, again)),
        "ms": cuda_ms(torch, lambda: emscatter.scatter_add_vtiles(
            wphi, lids, bv, nb=plan.nb, **geo), 20),
        "plain_ms": cuda_ms(torch, lambda: emscatter.scatter_add_vtiles_plain(
            wphi, lids, bv, **geo), 5),
        "bound_ms": t_bytes, "bound_by": by,
        "library_ms": cuda_ms(torch, library, 20),
    }


def check_estep(torch, rows, k, v, dev, rng, label, pick):
    """The gamma kernel on one scoring bucket of ``rows``: the most
    populated (``pick="docs"``) or the widest (``pick="width"``)."""
    from spark_text_clustering_tpu_torch.ops import estep
    from spark_text_clustering_tpu_torch.ops.lda_math import dirichlet_expectation
    from spark_text_clustering_tpu_torch.ops.sparse import bucket_by_length

    buckets = bucket_by_length(rows, device=dev)
    if pick == "docs":
        width = max(buckets, key=lambda w: len(buckets[w][1]))
    else:
        width = max(buckets)
    batch, idxs = buckets[width]
    lam = torch.from_numpy(rng.gamma(1.0, 20.0, (k, v)).astype(np.float32)).to(dev)
    eb_full = torch.exp(dirichlet_expectation(lam))
    eb = eb_full.T[batch.token_ids.long()].permute(0, 2, 1).contiguous()
    cts = batch.token_weights.contiguous()
    alpha = torch.full((k,), 50.0 / k + 1.0, device=dev)
    g0 = torch.ones((len(idxs), k), device=dev)
    got = estep.gamma_fixed_point_bkl(eb, cts, alpha, g0)
    want, iters = estep.gamma_fixed_point_bkl_plain(eb, cts, alpha, g0,
                                                   with_iters=True)
    torch.cuda.synchronize()
    gn = got / got.sum(1, keepdim=True)
    wn = want / want.sum(1, keepdim=True)
    err = float((gn - wn).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    if not err <= 5e-3 or not torch.equal(gn.argmax(1), wn.argmax(1)):
        raise AssertionError(
            f"gamma_fixed_point_bkl differs from its plain version by {err}")
    nnz = (cts > 0).sum(1).to(torch.float64)
    tile_b = min(8, len(idxs))
    per_doc_iters = iters.repeat_interleave(tile_b)[: len(idxs)].to(torch.float64)
    flops = float((per_doc_iters * nnz * (4 * k + 1)).sum())
    # bytes the kernel needs: eb of live slots only (it skips cts == 0
    # before reading eb), every slot's cts, alpha, gamma0 and the output
    live_eb = 4 * k * int(nnz.sum())
    t_bytes, by = bound(live_eb + nbytes(cts, alpha, g0, got), flops)
    return {
        "name": "gamma_fixed_point_bkl", "config": label, "bucket": pick,
        "shape": [len(idxs), k, width],
        "tile_iterations_max": int(iters.max()),
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": "normalized gamma atol 5e-3",
        "ms": cuda_ms(torch, lambda: estep.gamma_fixed_point_bkl(
            eb, cts, alpha, g0), 5),
        "plain_ms": cuda_ms(torch, lambda: estep.gamma_fixed_point_bkl_plain(
            eb, cts, alpha, g0), 2),
        "bound_ms": t_bytes, "bound_by": by, "library_ms": None,
    }


# ---- phases 3 and 4: the main path ----------------------------------------
def check_distribution(dist, n, k, label):
    if dist.shape != (n, k) or not np.isfinite(dist).all():
        raise AssertionError(f"{label}: bad topic distribution {dist.shape}")
    if not np.allclose(dist.sum(1), 1.0, atol=1e-4):
        raise AssertionError(f"{label}: distributions do not sum to 1")


def run_config(torch, label, rows, vocab, k, seed, workdir,
               resume_state=None):
    """IDF -> EM fit -> save -> load -> padded scoring -> report, on the
    card, through the library's entry points.  Returns the summary and
    what the CPU re-run needs."""
    from spark_text_clustering_tpu_torch import (
        IDF, LDA, Params, load_model,
    )
    from spark_text_clustering_tpu_torch.interop import em_state_from_numpy
    from spark_text_clustering_tpu_torch.models.persistence import model_dir_name
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.utils.report import (
        format_scoring_report,
    )

    ds = {"rows": rows, "vocab": vocab}
    _build.reset_launches()
    t0 = time.perf_counter()
    idf = IDF(min_doc_freq=2, idf_floor=1e-4).fit(ds)
    tfidf = idf.transform(ds)
    t_idf = time.perf_counter() - t0
    ckpt = None
    if resume_state is not None:
        ckpt = os.path.join(workdir, f"{label}_ckpt_cuda")
        em_state_from_numpy(ckpt, *resume_state(tfidf["rows"]), step=0)
    params = Params(k=k, max_iterations=SWEEPS, seed=seed,
                    checkpoint_dir=ckpt, checkpoint_interval=10 * SWEEPS)
    t0 = time.perf_counter()
    fitted = LDA(params).fit(tfidf)
    t_fit = time.perf_counter() - t0
    model = fitted.model
    path = model_dir_name(label, os.path.join(workdir, "models"))
    model.save(path)
    loaded = load_model(path)
    t0 = time.perf_counter()
    dist = loaded.topic_distribution(tfidf["rows"], layout="padded")
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    report = format_scoring_report(
        loaded, [f"doc{i}" for i in range(len(rows))], dist, tfidf["rows"])
    launches = dict(_build.LAUNCHES)
    check_distribution(dist, len(rows), k, label)
    n = fitted.corpus_size
    summary = {
        "phase": f"config_{label}", "docs": len(rows), "vocab": len(vocab),
        "k": k, "sweeps": SWEEPS,
        "tokens": int(sum(len(i) for i, _ in rows)),
        "idf_s": t_idf, "fit_s": t_fit,
        "fit_ms_per_sweep": 1e3 * float(np.mean(model.iteration_times)),
        "avg_log_likelihood": fitted.log_likelihood / n,
        "argmax_histogram": np.bincount(dist.argmax(1), minlength=k).tolist(),
        "score_s": t_score, "report_bytes": len(report.encode()),
        "launches": launches,
    }
    return summary, tfidf, ckpt, model


def profile_configs(torch, rows_a, rows_b, seed, out_dir):
    """torch.profiler over one fit and the padded scoring of each config
    (count rows, no IDF): device time by kernel name, and the device's
    busy share of the window's wall time.  The full tables go to
    ``<out_dir>/profile_{A,B}.txt`` when ``out_dir`` is given."""
    from torch.profiler import ProfilerActivity, profile

    from spark_text_clustering_tpu_torch import EMLDA, Params

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    for label, rows, k, v in (("A", rows_a, EN_K, EN_V),
                              ("B", rows_b, NG_K, NG_V)):
        vocab = [f"t{i}" for i in range(v)]
        opt = EMLDA(Params(k=k, max_iterations=SWEEPS, seed=seed))
        opt.fit(rows, vocab, max_iterations=1).topic_distribution(
            rows, layout="padded")                          # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model = opt.fit(rows, vocab)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.topic_distribution(rows, layout="padded")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        events = prof.key_averages()
        busy_us = sum(dev_us(e) for e in events)
        top = sorted(events, key=lambda e: -dev_us(e))[:8]
        if out_dir:
            with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
                f.write(events.table(sort_by="self_cuda_time_total",
                                     row_limit=30))
        emit({
            "phase": f"profile_{label}", "fit_s": t1 - t0,
            "score_s": t2 - t1, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / (t2 - t0),
            "top_device_ms": [[e.key[:60], dev_us(e) / 1e3] for e in top],
        })


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one fit and scoring of each config")
    ap.add_argument("--out", default=None,
                    help="directory for the full JSON record, the profile "
                         "tables and the compiler's register reports")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and hold the kernels against their plain "
                         "versions, then stop (no result line)")
    args = ap.parse_args()

    import torch

    import spark_text_clustering_tpu_torch  # noqa: F401  (the port, or fail)
    from spark_text_clustering_tpu_torch import EMLDA, Params
    from spark_text_clustering_tpu_torch.interop import em_state_from_numpy
    from spark_text_clustering_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 1. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    build = {"phase": "build", "seconds": time.perf_counter() - t0,
             "per_source_s": secs}
    emit(build)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name in _build.SOURCES:
            log = _build._lib_path(name).with_suffix(".log")
            if log.exists():
                shutil.copy(log, os.path.join(args.out, f"ptxas_{name}.log"))

    t0 = time.perf_counter()
    rows_a = en_books_rows(args.seed)
    rows_b = newsgroups_rows(args.seed)
    emit({"phase": "corpora", "seconds": time.perf_counter() - t0,
          "A_docs": len(rows_a), "A_tokens": sum(len(i) for i, _ in rows_a),
          "B_docs": len(rows_b), "B_tokens": sum(len(i) for i, _ in rows_b)})

    # 2. each kernel against its plain version, at main-path shapes
    rng = np.random.default_rng(args.seed + 1)
    checks = {
        "em_sweep_fused": check_sweep(torch, rows_a, dev, rng),
        "scatter_add_vtiles": check_scatter(torch, rows_b, dev, rng),
    }
    esteps = [
        check_estep(torch, rows, k, v, dev, rng, label, pick)
        for label, rows, k, v in (("A", rows_a, EN_K, EN_V),
                                  ("B", rows_b, NG_K, NG_V))
        for pick in ("docs", "width")
    ]
    for c in (checks["em_sweep_fused"], checks["scatter_add_vtiles"], *esteps):
        emit({"phase": "kernel_vs_plain", **c})
    if args.kernels_only:
        return 0

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # 3. config A, resumed from one random start drawn on the CPU
        def start_a(tf_rows):
            gen = torch.Generator().manual_seed(args.seed)
            n_wk = torch.zeros((EN_K, EN_V))
            n_dk = torch.zeros((len(tf_rows), EN_K))
            for d, (ids, w) in enumerate(tf_rows):
                e = torch.empty((len(ids), EN_K)).exponential_(generator=gen)
                wphi = torch.from_numpy(w)[:, None] * e / e.sum(1, keepdim=True)
                n_dk[d] = wphi.sum(0)
                n_wk.index_add_(1, torch.from_numpy(ids).long(), wphi.T)
            return n_wk.numpy(), n_dk.numpy()

        vocab_a = [f"t{i}" for i in range(EN_V)]
        summary_a, tfidf_a, _, model_a = run_config(
            torch, "A", rows_a, vocab_a, EN_K, args.seed,
            workdir, resume_state=start_a)
        ckpt_cpu = os.path.join(workdir, "A_ckpt_cpu")
        em_state_from_numpy(ckpt_cpu, *start_a(tfidf_a["rows"]), step=0)
        t0 = time.perf_counter()
        cpu_opt = EMLDA(Params(k=EN_K, max_iterations=SWEEPS,
                               checkpoint_dir=ckpt_cpu,
                               checkpoint_interval=10 * SWEEPS),
                        device="cpu")
        cpu_model = cpu_opt.fit(tfidf_a["rows"], vocab_a)
        cpu_avg = cpu_opt.last_log_likelihood / len(rows_a)
        rel = abs(cpu_avg - summary_a["avg_log_likelihood"]) / abs(cpu_avg)
        summary_a.update({
            "cpu_plain_avg_log_likelihood": cpu_avg,
            "cpu_plain_fit_s": time.perf_counter() - t0,
            "avg_log_likelihood_rel_diff": rel,
            "lam_max_rel_diff": float(np.max(
                np.abs(cpu_model.lam - model_a.lam)
                / np.maximum(np.abs(cpu_model.lam), 1.0))),
        })
        if summary_a["launches"]["em_sweep_fused"] == 0 or (
            summary_a["launches"]["gamma_fixed_point_bkl"] == 0
        ):
            raise AssertionError(f"config A skipped a kernel: "
                                 f"{summary_a['launches']}")
        if not rel <= 1e-4:
            raise AssertionError(
                f"config A: CUDA and CPU avg logLik differ by {rel}")
        emit(summary_a)

        # 4. config B
        vocab_b = [f"h{i}" for i in range(NG_V)]
        summary_b, _, _, _ = run_config(
            torch, "B", rows_b, vocab_b, NG_K, args.seed, workdir)
        if summary_b["launches"]["scatter_add_vtiles"] == 0 or (
            summary_b["launches"]["gamma_fixed_point_bkl"] == 0
        ):
            raise AssertionError(f"config B skipped a kernel: "
                                 f"{summary_b['launches']}")
        if not np.isfinite(summary_b["avg_log_likelihood"]):
            raise AssertionError("config B: log-likelihood is not finite")
        emit(summary_b)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    if args.profile:
        profile_configs(torch, rows_a, rows_b, args.seed, args.out)

    # 5. the kernels line; the gamma row is config B's most populated
    # bucket, and its error the largest of the four buckets checked
    kernels = [
        checks["em_sweep_fused"],
        checks["scatter_add_vtiles"],
        {**esteps[2], "route": "cuda",
         "source": "spark_text_clustering_tpu_torch/csrc/estep.cu",
         "replaces": "spark_text_clustering_tpu/ops/pallas_estep.py:161",
         "max_abs_err": max(e["max_abs_err"] for e in esteps),
         "buckets": esteps},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = []
    for kern in kernels:
        name = kern["name"]
        kern["launches"] = (summary_a["launches"][name]
                            + summary_b["launches"][name])
        if kern["launches"] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        line.append({k_: kern[k_] for k_ in keys})
    record.update(build=build, kernels=kernels, config_A=summary_a,
                  config_B=summary_b)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
