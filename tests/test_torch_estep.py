"""The padded E-step kernel (``csrc/estep.cu``): its own CUDA source,
compiled with g++ against the CPU stand-in for the CUDA runtime
(``cuda_shim``), held against the plain version
(``ops.estep.gamma_fixed_point_bkl_plain``, itself held against the JAX
package's Pallas kernel in ``test_torch_kernels.py``) in every one of its
seven instances, at k from 5 to 1,740; and the port at k = 100 against the
JAX package's scoring.

The stand-in runs a block's threads as CPU threads that meet at real
barriers, so widths and iterations are kept small.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from cuda_shim import build_on_cpu
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.persistence import load_model as j_load
from spark_text_clustering_tpu_torch import load_model
from spark_text_clustering_tpu_torch.ops import _build
from spark_text_clustering_tpu_torch.ops import estep as testep

TOL = 1e-3


@pytest.fixture(scope="module")
def estep_on_cpu(tmp_path_factory):
    return build_on_cpu("estep", "estep_kernel", 0,
                        tmp_path_factory.mktemp("estep_kernel"))


def _problem(b, k, l, seed=0):
    """(eb [B, k, L], cts [B, L], alpha [k], gamma0 [B, k]): doc 1 all
    pad, the others live on a prefix of random length, NaN in every pad
    slot's eb (a read of one would show)."""
    rng = np.random.default_rng(seed)
    eb = rng.gamma(1.0, 1.0, (b, k, l)).astype(np.float32)
    lens = rng.integers(1, l + 1, b)
    lens[min(1, b - 1)] = 0
    cts = rng.integers(1, 6, (b, l)).astype(np.float32)
    pad = np.arange(l)[None, :] >= lens[:, None]
    cts[pad] = 0.0
    eb[np.broadcast_to(pad[:, None, :], eb.shape)] = np.nan
    alpha = np.full(k, 1.0 / k, np.float32)
    g0 = rng.gamma(100.0, 0.01, (b, k)).astype(np.float32)
    return eb, cts, alpha, g0


def _run(lib, eb, cts, alpha, g0, max_inner, cluster):
    b, k, l = eb.shape
    out = np.full((b, k), np.nan, np.float32)
    err = lib.stc_gamma_fixed_point_bkl(
        eb.ctypes.data, cts.ctypes.data, alpha.ctypes.data, g0.ctypes.data,
        b, k, l, min(8, b), cluster, max_inner, TOL, out.ctypes.data, None)
    assert err == 0
    return out


# case: (b, k, L, cluster, max_inner); b = 13 and 3 are no multiple of
# tile_b = 8 (the last tile pads), cluster 2 and 4 split L over CTAs; the
# instance is chip_smoke.estep_instance's (the copy of geometry()).  Only
# l2_k8 needs a wide L: below ~8,000 slots a k <= 8 slab fits in shared
# memory.  The wide instance walks a CTA's slice in ratio chunks: one in
# most cases, two of 1,024 slots at L = 2,048, and at k = 1,740 (cluster
# 2) chunks the tile state cuts to 64 slots, the second one short.
_CASES = {
    "k5_slab": (13, 5, 128, 1, 30, "slab_k8"),
    "k5_l2": (3, 5, 8192, 2, 6, "l2_k8"),
    "k20_phase": (13, 20, 64, 1, 100, "phase_k32"),
    "k20_l2": (13, 20, 512, 1, 15, "l2_k32"),
    "k64_phase": (13, 64, 64, 1, 20, "phase_k64"),
    "k64_l2": (9, 64, 256, 1, 8, "l2_k64"),
    "k65_wide": (5, 65, 96, 1, 20, "wide"),
    "k100_wide": (13, 100, 64, 2, 8, "wide"),
    "k129_wide": (11, 129, 96, 1, 8, "wide"),
    "k1024_wide": (3, 1024, 64, 2, 3, "wide"),
    "k100_wide_two_chunks": (3, 100, 2048, 1, 2, "wide"),
    "k1740_wide_short_chunks": (8, 1740, 160, 2, 1, "wide"),
    "k100_max_inner_0": (13, 100, 64, 1, 0, "wide"),
    "k20_max_inner_0": (13, 20, 64, 2, 0, "phase_k32"),
}


def test_cases_reach_every_instance():
    assert {c[-1] for c in _CASES.values()} == chip_smoke.ESTEP_INSTANCES
    for b, k, l, cs, _, inst in _CASES.values():
        assert chip_smoke.estep_instance(k, l, min(8, b), cs) == inst
    chunks = {chip_smoke.estep_wide_chunks(k, l, min(8, b), cs)
              for b, k, l, cs, _, inst in _CASES.values() if inst == "wide"}
    assert (1024, 2) in chunks and (64, 2) in chunks


@pytest.mark.parametrize("case", list(_CASES))
def test_estep_kernel_source_on_cpu_threads(estep_on_cpu, case):
    """The kernel's own source on CPU threads against the plain version:
    normalized gamma within 1e-5 with equal argmax (the cases differ by at
    most 7.6e-7 here), a bit-for-bit repeat, the all-pad doc's gamma
    alpha exactly, max_inner 0 gamma0 itself."""
    b, k, l, cs, max_inner, _ = _CASES[case]
    eb, cts, alpha, g0 = _problem(b, k, l, seed=k + l)
    got = _run(estep_on_cpu, eb, cts, alpha, g0, max_inner, cs)
    np.testing.assert_array_equal(
        _run(estep_on_cpu, eb, cts, alpha, g0, max_inner, cs), got)
    want = testep.gamma_fixed_point_bkl_plain(
        torch.from_numpy(np.nan_to_num(eb)), torch.from_numpy(cts),
        torch.from_numpy(alpha), torch.from_numpy(g0), max_inner, TOL,
        min(8, b)).numpy()
    gn = got / got.sum(1, keepdims=True)
    wn = want / want.sum(1, keepdims=True)
    assert np.abs(gn - wn).max() <= 1e-5
    np.testing.assert_array_equal(gn.argmax(1), wn.argmax(1))
    if max_inner == 0:
        np.testing.assert_array_equal(got, g0)
    else:
        np.testing.assert_array_equal(got[1], alpha)


def test_estep_max_k_is_the_wide_state_in_shared_memory(estep_on_cpu,
                                                        monkeypatch):
    """The library reports its largest k from the wide path's tile state
    (k + 4 tile_b k floats and 8 stop words at tile_b = 8, with a 32-slot
    ratio chunk of each of the 8 docs, in 227 KB); the C entry and the
    wrapper refuse k just past it, the wrapper before any launch."""
    lib = estep_on_cpu
    max_k = lib.stc_estep_max_k()
    assert max_k == (232448 // 4 - 8 - 8 * 32) // 33 >= 1024
    z = np.zeros(8 * (max_k + 1) * 32, np.float32)
    assert lib.stc_gamma_fixed_point_bkl(
        z.ctypes.data, z.ctypes.data, z.ctypes.data, z.ctypes.data,
        1, max_k + 1, 32, 1, 1, 10, TOL, z.ctypes.data, None) != 0
    monkeypatch.setattr(_build, "check_tensors", lambda *a: None)
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    f32 = dict(dtype=torch.float32, device="meta")
    k = max_k + 1
    with pytest.raises(ValueError, match=f"k <= {max_k}"):
        testep.gamma_fixed_point_bkl(
            torch.empty(2, k, 32, **f32), torch.empty(2, 32, **f32),
            torch.ones(k, **f32), torch.empty(2, k, **f32))


def test_wide_k_model_scores_like_jax(tmp_path, monkeypatch):
    """A k = 100 model saved by the JAX package: the port's padded
    ``topic_distribution`` (the plain version of the E-step on the CPU)
    against JAX's (its Pallas kernel in interpret mode), within 5e-3."""
    monkeypatch.setenv("STC_GAMMA_BACKEND", "pallas")
    k, v = 100, 400
    rng = np.random.default_rng(0)
    lam = rng.gamma(0.3, 20.0, (k, v)).astype(np.float32)
    model = JLDAModel(
        lam=lam, vocab=[f"w{i}" for i in range(v)],
        alpha=np.full((k,), 1.0 / k, np.float32), eta=1.0 / k,
        algorithm="online", step=10, iteration_times=[0.5])
    path = str(tmp_path / "LdaModel_EN_1000")
    model.save(path)
    rows = []
    for _ in range(13):
        nnz = int(rng.integers(3, 90))
        ids = np.sort(rng.choice(v, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, rng.integers(1, 9, nnz).astype(np.float32)))
    want = np.asarray(j_load(path).topic_distribution(rows, layout="padded"))
    got = load_model(path, device="cpu").topic_distribution(rows,
                                                            layout="padded")
    assert got.shape == (13, k)
    np.testing.assert_allclose(got, want, atol=5e-3)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
