"""Model persistence: one self-contained, integrity-checked artifact dir,
in the JAX package's layout, so a model saved by either package loads in
the other (``load_model`` also reads the reference's MLlib layout, see
``reference_import``):

    <path>/meta.json      format version, "class", k, vocab_size, step,
                          iteration_times; LDA: eta, gamma_shape,
                          algorithm; NMF: loss
    <path>/arrays.npz     LDA: lam [k, V] float32, alpha [k]; NMF: h [k, V]
    <path>/vocab.txt      one term per line (utf-8)
    <path>/MANIFEST.json  per-file SHA-256
    <path>/COMMIT         written last

``save_train_state`` / ``load_train_state`` write and read the mid-fit
checkpoint (``em_state.npz``: step plus named arrays) atomically, with a
``.sha256`` sidecar checked on load.  Both writers sit at the JAX
package's fault-injection sites (``artifact.file`` between the files of a
model dir, ``ckpt.write`` in the checkpoint write, which is retried under
the I/O policy), so one ``faultinject`` spec has the same outcome in both
packages.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Optional, Sequence

import numpy as np

from .. import telemetry
from ..resilience import (
    CorruptArtifactError,
    faultinject,
    retry_call,
    artifact_status,
    atomic_write_text,
    file_sha256,
    finalize_artifact_dir,
    verify_artifact,
)

FORMAT_VERSION = 2
# the class strings both packages write
LDA_CLASS = "spark_text_clustering_tpu.models.LDAModel"
NMF_CLASS = "spark_text_clustering_tpu.models.NMFModel"

__all__ = [
    "latest_model_dir",
    "load_model",
    "load_train_state",
    "model_dir_name",
    "resolve_latest_model",
    "save_model",
    "save_train_state",
    "train_state_valid",
]


def model_dir_name(lang: str, base: str = "models") -> str:
    """``<base>/LdaModel_<lang>_<epochMillis>``."""
    return os.path.join(base, f"LdaModel_{lang}_{int(time.time() * 1000)}")


def latest_model_dir(
    base: str, lang: str, verify_deep: bool = False
) -> Optional[str]:
    """Newest committed (or legacy, MLlib dirs included) model dir for
    ``lang`` under ``base``, by the timestamp in its name; a name whose
    suffix is no timestamp (``..._mllib``) is ignored, uncommitted dirs
    are skipped, and with ``verify_deep`` so are dirs whose manifest
    hashes fail."""
    if not os.path.isdir(base):
        return None
    prefix = f"LdaModel_{lang}_"
    cands = []
    for d in os.listdir(base):
        if not d.startswith(prefix):
            continue
        try:
            cands.append((int(d.rsplit("_", 1)[-1]), d))
        except ValueError:
            continue
    for _, d in sorted(cands, reverse=True):
        path = os.path.join(base, d)
        status = artifact_status(path)
        if status not in ("committed", "legacy"):
            telemetry.count("resilience.artifacts_skipped")
            telemetry.event(
                "artifact_skipped", path=path, status=status, lang=lang,
            )
            continue
        if verify_deep:
            try:
                verify_artifact(path)
            except CorruptArtifactError as exc:
                telemetry.count("resilience.artifacts_skipped")
                telemetry.event(
                    "artifact_skipped", path=path,
                    status="corrupt", lang=lang, error=str(exc),
                )
                continue
        return path
    if cands:
        # every candidate was partial or uncommitted
        telemetry.event(
            "artifact_none_valid", base=base, lang=lang,
            candidates=len(cands),
        )
    return None


def resolve_latest_model(
    models_dir: str,
    lang: str,
    explicit: Optional[str] = None,
    verify_deep: bool = False,
    device="cuda",
):
    """Model selection and load for ``score``: an ``explicit`` dir wins;
    otherwise the newest committed (with ``verify_deep``, re-hashed)
    artifact for ``lang`` under ``models_dir``.  Returns ``(path, model)``.
    No model at all, or a dir that fails to load, raises
    ``CorruptArtifactError``."""
    path = explicit or latest_model_dir(
        models_dir, lang, verify_deep=verify_deep
    )
    if path is None:
        raise CorruptArtifactError(
            models_dir or "<models-dir>",
            f"no committed model for lang {lang}",
        )
    return path, load_model(path, device=device)


def save_model(model, path: str, ledger_ref: Optional[dict] = None) -> None:
    """Write ``model`` (an ``LDAModel`` or ``NMFModel``) as a sealed
    artifact dir.  ``ledger_ref`` (``{"dir": ..., "epoch": n}``) records
    in meta.json the stream epoch ledger that published the model; the
    ledger's ``model-publish`` record holds the other direction
    (``resilience.artifact_ref``)."""
    from .nmf import NMFModel

    meta = {
        **({"ledger_ref": ledger_ref} if ledger_ref else {}),
        "format_version": FORMAT_VERSION,
        "k": model.k,
        "vocab_size": model.vocab_size,
        "step": int(model.step),
        "iteration_times": [float(t) for t in model.iteration_times],
        "iteration_times_kind": model.iteration_times_kind,
    }
    if isinstance(model, NMFModel):
        meta.update({"class": NMF_CLASS, "loss": float(model.loss)})
        arrays = {"h": np.asarray(model.h, np.float32)}
    else:
        meta.update({
            "class": LDA_CLASS,
            "eta": float(model.eta),
            "gamma_shape": float(model.gamma_shape),
            "algorithm": model.algorithm,
        })
        arrays = {"lam": np.asarray(model.lam, np.float32),
                  "alpha": np.asarray(model.alpha, np.float32)}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    faultinject.check("artifact.file")
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    faultinject.check("artifact.file")
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(model.vocab))
    faultinject.corrupt("artifact.file", os.path.join(path, "arrays.npz"))
    finalize_artifact_dir(path, files=("meta.json", "arrays.npz", "vocab.txt"))


def load_model(path: str, device="cuda"):
    """Load an LDA or NMF model dir written by either package, by the
    class its meta.json names, or a reference-format MLlib
    DistributedLDAModel dir (``metadata/part-00000`` and no meta.json;
    its vocabulary sidecar is required).  Any integrity failure raises
    ``CorruptArtifactError`` naming the artifact."""
    from .base import LDAModel
    from .nmf import NMFModel

    verify_artifact(path)
    if not os.path.exists(os.path.join(path, "meta.json")) and os.path.exists(
        os.path.join(path, "metadata", "part-00000")
    ):
        from .reference_import import load_reference_model

        return load_reference_model(path, placeholder_vocab_ok=False,
                                    device=device)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise CorruptArtifactError(path, f"unreadable meta.json: {exc}") from exc
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta['format_version']} newer than "
            f"supported {FORMAT_VERSION}"
        )
    cls = meta.get("class", LDA_CLASS)
    if cls not in (LDA_CLASS, NMF_CLASS):
        raise ValueError(f"{path} holds a {cls}; the port loads LDA and NMF "
                         "models")
    names = ("h",) if cls == NMF_CLASS else ("lam", "alpha")
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {name: z[name] for name in names}
    except KeyError as exc:
        raise CorruptArtifactError(path, f"missing array {exc}") from exc
    except (OSError, ValueError, zipfile.BadZipFile, EOFError) as exc:
        raise CorruptArtifactError(
            path, f"unreadable/truncated arrays.npz: {exc!r}"
        ) from exc
    try:
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            vocab = f.read().split("\n")
    except OSError as exc:
        raise CorruptArtifactError(path, f"unreadable vocab.txt: {exc}") from exc
    table = arrays[names[0]]
    if table.shape[1] != len(vocab):
        raise CorruptArtifactError(
            path, f"vocab length {len(vocab)} != {names[0]} vocab axis "
                  f"{table.shape[1]}"
        )
    common = dict(
        vocab=vocab,
        iteration_times=list(meta.get("iteration_times", [])),
        iteration_times_kind=meta.get("iteration_times_kind", "per_iteration"),
        step=int(meta.get("step", 0)),
        device=device,
    )
    if cls == NMF_CLASS:
        return NMFModel(h=table, loss=float(meta.get("loss", float("nan"))),
                        **common)
    try:
        return LDAModel(
            lam=table,
            alpha=arrays["alpha"],
            eta=float(meta["eta"]),
            gamma_shape=float(meta.get("gamma_shape", 100.0)),
            algorithm=meta.get("algorithm", "online"),
            **common,
        )
    except KeyError as exc:
        raise CorruptArtifactError(
            path, f"artifact is missing required field {exc}"
        ) from exc


def save_train_state(path: str, step: int, **arrays: np.ndarray) -> None:
    """Checkpoint (named arrays + step), written via tmp + rename, with a
    ``<path>.sha256`` sidecar, retried under the I/O policy.  Float arrays
    are stored as float32, integer ones (counters) as they are."""

    def _write() -> None:
        faultinject.check("ckpt.write")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(
            tmp,
            step=np.int64(step),
            **{
                k: (
                    a if np.issubdtype((a := np.asarray(v)).dtype, np.integer)
                    else a.astype(np.float32)
                )
                for k, v in arrays.items()
            },
        )
        digest = file_sha256(tmp)
        os.replace(tmp, path)
        atomic_write_text(
            path + ".sha256",
            json.dumps({"sha256": digest, "step": int(step)}, sort_keys=True)
            + "\n",
        )

    retry_call(_write, site="ckpt.write")


def train_state_valid(path: str) -> bool:
    """The checkpoint exists and its sidecar (when present) agrees."""
    if not os.path.exists(path):
        return False
    sidecar = path + ".sha256"
    if not os.path.exists(sidecar):
        return True
    try:
        with open(sidecar, encoding="utf-8") as f:
            return json.load(f).get("sha256") == file_sha256(path)
    except (OSError, json.JSONDecodeError, ValueError):
        return False


def load_train_state(path: str, require: Sequence[str] = ()) -> dict:
    """{'step': int, <name>: np.ndarray, ...}; every failure mode raises
    ``CorruptArtifactError`` carrying the path."""
    if not os.path.exists(path):
        raise CorruptArtifactError(path, "checkpoint file does not exist")
    sidecar = path + ".sha256"
    if os.path.exists(sidecar):
        try:
            with open(sidecar, encoding="utf-8") as f:
                want = json.load(f).get("sha256")
        except (OSError, json.JSONDecodeError, ValueError) as exc:
            raise CorruptArtifactError(
                path, f"unreadable checksum sidecar: {exc}"
            ) from exc
        if want != file_sha256(path):
            raise CorruptArtifactError(path, "checksum mismatch")
    out = {}
    try:
        with np.load(path) as z:
            for k in z.files:
                out[k] = int(z[k]) if k == "step" else z[k]
    except (OSError, ValueError, zipfile.BadZipFile, EOFError) as exc:
        raise CorruptArtifactError(
            path, f"unreadable/truncated state file: {exc!r}"
        ) from exc
    missing = [k for k in ("step", *require) if k not in out]
    if missing:
        raise CorruptArtifactError(
            path, f"state file is missing required keys {missing}"
        )
    return out
