"""The per-document kernel of scoring (``csrc/segments.cu``): its own CUDA
source, compiled with g++ against the CPU stand-in for the CUDA runtime
(``cuda_shim``), held against the plain version
(``ops.segments.topic_inference_segments_plain``, the port's
``lda_math.topic_inference_segments(freeze=True)``, itself held against the
JAX package's in ``test_torch_scoring.py``).

The kernel's contract is the serving one: a document's bytes depend on its
own tokens only, never on its offset, its batchmates, the batch's token
width T, the cluster size C of the launch or the shared-memory capacity
that decides which pieces are staged.  Pad slots are filled with NaN here,
so a read of one would show.  The threads of the stand-in meet at real
barriers (a cluster's blocks run at once, 2,048 threads at C=4), so
iterations and documents are kept few.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from cuda_shim import build_on_cpu
from spark_text_clustering_tpu_torch.models import base as tbase
from spark_text_clustering_tpu_torch.ops import _build
from spark_text_clustering_tpu_torch.ops import lda_math as tlda
from spark_text_clustering_tpu_torch.ops import segments as tseg

V = 300
TOL = 1e-3


@pytest.fixture(scope="module")
def seg_kernel_on_cpu(tmp_path_factory):
    return build_on_cpu("segments", "segments_kernel", 0,
                        tmp_path_factory.mktemp("segments_kernel"))


def _eb(k, seed=0):
    """exp(E[log beta]) [V, k] of a random lambda."""
    rng = np.random.default_rng(seed)
    lam = torch.from_numpy(rng.gamma(0.5, 4.0, (k, V)).astype(np.float32))
    eb = torch.exp(tlda.dirichlet_expectation(lam.clamp(min=1e-30)))
    return eb.T.contiguous().numpy()


def _docs(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, n).astype(np.int64),
             rng.integers(1, 9, n).astype(np.float32)) for n in lens]


def _pack(eb_vk, docs, t=None):
    """(eb_tok [T, k], cts [T], offsets [B + 1]) with NaN in the pad slots."""
    k = eb_vk.shape[1]
    lens = [len(i) for i, _ in docs]
    n = sum(lens)
    t = max(1, n) if t is None else t
    eb_tok = np.full((t, k), np.nan, np.float32)
    cts = np.full(t, np.nan, np.float32)
    if n:
        eb_tok[:n] = eb_vk[np.concatenate([i for i, _ in docs])]
        cts[:n] = np.concatenate([w for _, w in docs])
    return eb_tok, cts, tseg.pack_offsets(lens)


def _run(lib, eb_tok, cts, offsets, alpha, gamma0, max_inner, cluster=1,
         smem_cap=None):
    b, k = gamma0.shape
    t = len(cts)
    cap = lib.stc_segments_smem_limit() if smem_cap is None else smem_cap
    out = np.full((b, k), np.nan, np.float32)
    n_scratch = lib.stc_segments_scratch_floats(k, t, b, cluster, cap)
    assert n_scratch >= 0
    scratch = np.full(max(1, n_scratch), np.nan, np.float32)
    err = lib.stc_topic_inference_segments(
        eb_tok.ctypes.data, cts.ctypes.data, offsets.ctypes.data,
        alpha.ctypes.data, gamma0.ctypes.data, b, k, t, cluster, cap,
        max_inner, TOL, out.ctypes.data,
        scratch.ctypes.data if n_scratch else None, None)
    assert err == 0
    return out


def _plain(eb_tok, cts, offsets, alpha, gamma0, max_inner):
    n = int(offsets[-1])
    t = max(8, n)
    e = np.zeros((t, eb_tok.shape[1]), np.float32)
    c = np.zeros(t, np.float32)
    e[:n], c[:n] = eb_tok[:n], cts[:n]
    dist, iters = tseg.topic_inference_segments_plain(
        torch.from_numpy(e), torch.from_numpy(c), torch.from_numpy(offsets),
        torch.from_numpy(alpha), torch.from_numpy(gamma0), max_inner, TOL,
        with_iters=True)
    return dist.numpy(), iters.numpy()


# case: (k, doc lengths, max_inner); 0 is an empty doc, 1300 a doc of 6
# pieces of 256 tokens (at C=4 two CTAs take two pieces, two one), k=33
# walks the topics in two chunks (pieces of 128) through the staged ratio
_CASES = {
    "k5": (5, [40, 0, 1300, 7], 6),
    "k20": (20, [60, 25], 3),
    "k33": (33, [70, 0, 30], 2),
    "max_inner_0": (5, [40, 0, 9], 0),
    "max_inner_1": (5, [40, 0, 9], 1),
    "k128": (128, [24], 2),
}


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("case", list(_CASES))
def test_segments_kernel_source_on_cpu_threads(seg_kernel_on_cpu, case,
                                               cluster):
    """The CUDA kernel's own source on CPU threads, a cluster of 1 and of 4
    CTAs a doc, against the plain version: the distribution within 1e-5, a
    bit-for-bit repeat, an empty doc exactly uniform, max_inner=0 the
    normalized gamma0."""
    lib = seg_kernel_on_cpu
    k, lens, max_inner = _CASES[case]
    eb_vk = _eb(k)
    docs = _docs(lens)
    eb_tok, cts, offsets = _pack(eb_vk, docs, t=sum(lens) + 13)
    rng = np.random.default_rng(5)
    alpha = np.full(k, 1.0 / k, np.float32) if k > 5 else (
        np.float32(11.0) * np.ones(k, np.float32))
    gamma0 = (rng.gamma(100.0, 0.01, (len(lens), k)).astype(np.float32)
              if max_inner == 0 else np.ones((len(lens), k), np.float32))
    got = _run(lib, eb_tok, cts, offsets, alpha, gamma0, max_inner, cluster)
    np.testing.assert_array_equal(
        _run(lib, eb_tok, cts, offsets, alpha, gamma0, max_inner, cluster),
        got)
    want, iters = _plain(eb_tok, cts, offsets, alpha, gamma0, max_inner)
    assert np.abs(got - want).max() <= 1e-5
    empty = np.asarray(lens) == 0
    np.testing.assert_array_equal(
        got[empty], np.full((int(empty.sum()), k), np.float32(1.0 / k)))
    if max_inner == 0:
        live = ~empty
        np.testing.assert_allclose(
            got[live], gamma0[live] / gamma0[live].sum(1, keepdims=True),
            rtol=1e-6)
    else:
        assert iters[~empty].max() <= max_inner


@pytest.mark.parametrize("cluster", [1, 4])
def test_segments_kernel_bytes_follow_the_document_alone(seg_kernel_on_cpu,
                                                         cluster):
    """Doc ``x`` scored alone at T = its length, alone at T = 4096, first of
    a batch, and third of another batch at another T: equal bytes, at a
    cluster of 1 and of 4 CTAs a doc."""
    lib = seg_kernel_on_cpu
    k = 5
    eb_vk = _eb(k, seed=3)
    x, a, b, c = _docs([700, 90, 33, 26], seed=4)
    alpha = np.full(k, 11.0, np.float32)

    def row_of(docs, pos, t=None):
        eb_tok, cts, offsets = _pack(eb_vk, docs, t)
        g0 = np.ones((len(docs), k), np.float32)
        return _run(lib, eb_tok, cts, offsets, alpha, g0, 4, cluster)[pos]

    alone = row_of([x], 0)
    assert alone.tobytes() == row_of([x], 0, t=4096).tobytes()
    assert alone.tobytes() == row_of([x, a], 0, t=2048).tobytes()
    assert alone.tobytes() == row_of([c, b, x], 2, t=8192).tobytes()
    assert not np.allclose(alone, 1.0 / k)


@pytest.mark.parametrize("cluster", [1, 4])
def test_segments_kernel_refuses_k_past_its_cap(seg_kernel_on_cpu,
                                                monkeypatch, cluster):
    """k = 129 is refused by the C entry point and, before any launch, by
    the wrapper with ``KernelError``: no fallback.  So is a cluster size
    other than 1, 2, 4, 8 or 16."""
    lib = seg_kernel_on_cpu
    assert lib.stc_segments_max_k() == 128
    cap = lib.stc_segments_smem_limit()
    z = np.zeros(8, np.float32)
    off = np.array([0, 1], np.int32)
    assert lib.stc_topic_inference_segments(
        z.ctypes.data, z.ctypes.data, off.ctypes.data, z.ctypes.data,
        z.ctypes.data, 1, 129, 8, cluster, cap, 10, TOL, z.ctypes.data,
        z.ctypes.data, None) != 0
    assert lib.stc_segments_scratch_floats(129, 8, 1, cluster, cap) < 0
    assert lib.stc_segments_scratch_floats(5, 8, 1, 3 * cluster, cap) < 0
    monkeypatch.setattr(_build, "check_tensors", lambda *a: None)
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    f32 = dict(dtype=torch.float32, device="meta")
    with pytest.raises(_build.KernelError, match="k <= 128"):
        tseg.topic_inference_segments(
            torch.empty(8, 129, **f32), torch.empty(8, **f32),
            torch.empty(2, dtype=torch.int32, device="meta"),
            torch.ones(129, **f32), torch.empty(1, 129, **f32),
            cluster=cluster)
    with pytest.raises(_build.KernelError, match="cluster"):
        tseg.topic_inference_segments(
            torch.empty(8, 5, **f32), torch.empty(8, **f32),
            torch.empty(2, dtype=torch.int32, device="meta"),
            torch.ones(5, **f32), torch.empty(1, 5, **f32),
            cluster=17 * cluster)


# (k, the doc's length, max_inner): a doc of 5 pieces of 256 tokens and a
# k=128 doc of 2 pieces of 128, each scored with shared memory at the
# card's capacity and at two shrunken ones (``_caps``)
_CAPS = {"k5": (5, 1100, 3), "k128": (128, 200, 1)}


def _caps(k, piece):
    """Shared bytes a CTA may use, at T = 4096 and C = 1: room to stage one
    piece (the rest streamed from device memory), and room for the partial
    sums of two pieces only (the rest through the scratch, nothing
    staged)."""
    part = 2 * min(4096 // piece, 8192 // (2 * k)) * k
    stage = piece * (k + 1 + (k > 32))
    return 4 * (160 + part + stage), 4 * (160 + 2 * 2 * k)


@pytest.mark.parametrize("case", list(_CAPS))
def test_segments_kernel_bytes_equal_at_every_cluster_size(seg_kernel_on_cpu,
                                                           case):
    """One document's bytes at C = 1, 2 and 4, alone with shared memory at
    the card's capacity and second of a batch at both shrunken ones: all
    equal, and within 1e-5 of the plain version."""
    lib = seg_kernel_on_cpu
    k, n, max_inner = _CAPS[case]
    one_staged, two_parts = _caps(k, lib.stc_segments_piece_tokens(k))
    assert lib.stc_segments_stage_pieces(k, 4096, 1, one_staged) == 1
    assert lib.stc_segments_scratch_floats(k, 4096, 2, 1, one_staged) == (
        4096 if k > 32 else 0)
    assert lib.stc_segments_stage_pieces(k, 4096, 1, two_parts) == 0
    assert lib.stc_segments_scratch_floats(k, 4096, 2, 1, two_parts) > (
        4096 if k > 32 else 0)
    eb_vk = _eb(k, seed=6)
    x, y = _docs([n, 40], seed=7)
    alpha = np.full(k, 1.0 / k if k > 5 else 11.0, np.float32)
    rows = []
    for docs, pos, caps in (([x], 0, [None]),
                            ([y, x], 1, [one_staged, two_parts])):
        eb_tok, cts, offsets = _pack(eb_vk, docs, t=4096)
        g0 = np.ones((len(docs), k), np.float32)
        for c in (1, 2, 4):
            for cap in caps:
                rows.append(_run(lib, eb_tok, cts, offsets, alpha, g0,
                                 max_inner, c, cap)[pos])
    assert len(rows) == 9
    assert all(r.tobytes() == rows[0].tobytes() for r in rows)
    eb_tok, cts, offsets = _pack(eb_vk, [x])
    want, _ = _plain(eb_tok, cts, offsets, alpha,
                     np.ones((1, k), np.float32), max_inner)
    assert np.abs(rows[0] - want[0]).max() <= 1e-5


def test_segments_wrapper_never_falls_back_off_the_cpu():
    """A tensor off the CPU never takes the plain version: the wrapper's
    checks raise first (here on 'meta' tensors, which are not on a card)."""
    f32 = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tseg.topic_inference_segments(
            torch.empty(8, 5, **f32), torch.empty(8, **f32),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.ones(5, **f32), torch.empty(2, 5, **f32))


def test_packed_scoring_passes_the_docs_offsets(monkeypatch):
    """``topic_distribution(..., convergence="per_doc")`` hands
    ``topic_inference_segments`` offsets that give the same documents as
    its ``seg`` (on the card the kernel reads only the offsets)."""
    seen = []
    inner = tbase.topic_inference_segments

    def spy(eb_tok, cts, seg, *args, offsets=None, **kw):
        seen.append((seg.clone(), offsets.clone(), cts.clone()))
        return inner(eb_tok, cts, seg, *args, offsets=offsets, **kw)

    monkeypatch.setattr(tbase, "topic_inference_segments", spy)
    from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy

    rng = np.random.default_rng(0)
    model = lda_model_from_numpy(rng.random((4, V)) + 0.1, 0.5, 1.1,
                                 [f"w{i}" for i in range(V)])
    rows = [(np.sort(rng.choice(V, n, replace=False)).astype(np.int32),
             np.ones(n, np.float32)) for n in (12, 0, 30, 5)]
    model.topic_distribution(rows, convergence="per_doc", device="cpu")
    (seg, offsets, cts), = seen
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 12, 12, 42, 47]
    live = cts > 0
    assert torch.equal(tseg.offsets_to_seg(offsets, seg.numel())[live],
                       seg[live])


def test_offsets_round_trip():
    off = tseg.pack_offsets([3, 0, 2])
    assert off.dtype == np.int32 and off.tolist() == [0, 3, 3, 5]
    seg = tseg.offsets_to_seg(torch.from_numpy(off), 8)
    assert seg.tolist() == [0, 0, 0, 2, 2, 0, 0, 0]
    assert ctypes.sizeof(ctypes.c_int) == 4


def test_cluster_size_fills_the_card_with_clusters_that_fit(
        seg_kernel_on_cpu, monkeypatch):
    """The rule: the largest power of two <= 16 whose clusters for every
    doc slot fit on the card at once (the stand-in places 132 / C); the
    wrapper asks the library once per (device, k, T, doc slots)."""
    assert tseg.cluster_size(1, 132) == 16
    assert tseg.cluster_size(8, 132) == 16
    assert tseg.cluster_size(8, 132, fits=lambda c: c <= 8) == 8
    assert tseg.cluster_size(51, 132) == 2
    assert tseg.cluster_size(133, 132) == 1
    assert tseg.cluster_size(8, 132, fits=lambda c: False) == 1
    lib = seg_kernel_on_cpu
    monkeypatch.setattr(tseg.estep, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tseg, "_CLUSTERS", {})
    cpu = torch.device("cpu")
    assert tseg._pick_cluster(lib, cpu, 5, 4096, 8) == 16
    assert tseg._pick_cluster(lib, cpu, 5, 4096, 9) == 8
    assert tseg._pick_cluster(lib, cpu, 20, 4096, 20) == 4
    assert len(tseg._CLUSTERS) == 3
    # a CTA takes what its pieces of a doc of all T tokens need, within
    # the budget: 8 pieces of 256 at T = 16,384 and C = 8; at T = 262,144
    # the budget's 23 of the 128 pieces a CTA could own
    budget = lib.stc_segments_smem_budget()
    assert budget < lib.stc_segments_smem_limit()
    assert lib.stc_segments_stage_pieces(5, 16384, 8, budget) == 8
    assert lib.stc_segments_stage_pieces(5, 262144, 8, budget) == 23
    assert lib.stc_segments_smem_bytes(5, 262144, 8, budget) <= budget
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    assert tseg.launch_plan(5, 4096, 8, cpu) == {
        "cluster": 16, "smem_bytes": 4 * (160 + 2 * 1 * 5 + 256 * 6),
        "stage_pieces": 1, "piece_tokens": 256}
    assert tseg.launch_plan(5, 4096, 8, cpu, cluster=2)["stage_pieces"] == 8
