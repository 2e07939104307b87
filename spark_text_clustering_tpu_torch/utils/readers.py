"""Corpus ingestion: the ``sc.wholeTextFiles`` equivalent (the port's copy
of the JAX package's reader).

The reference reads one record per file (LDAClustering.scala:113) and later
escapes ',' to '?' in paths because wholeTextFiles treats commas as path
separators (LDALoader.scala:81) — our reader has no such restriction, but the
report writer reproduces the '?' in book names for golden-output parity.

Data-hygiene quirk handled here: the corpus contains a stray
``books/Russian/desktop.ini`` which Spark would ingest as a document
(SURVEY.md §2.6); ``read_text_dir`` filters by suffix, with
``include_all=True`` to reproduce the reference's behavior.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional

__all__ = ["Document", "read_text_dir", "read_stop_word_file", "list_books"]


@dataclass
class Document:
    doc_id: int       # stable id: sorted-path rank (zipWithIndex equivalent)
    path: str
    text: str


def list_books(
    directory: str,
    suffix: Optional[str] = ".txt",
    include_all: bool = False,
) -> List[str]:
    """Deterministic (sorted) file listing of a corpus directory."""
    names = sorted(os.listdir(directory))
    paths = []
    for n in names:
        p = os.path.join(directory, n)
        if not os.path.isfile(p):
            continue
        if include_all or suffix is None or n.endswith(suffix):
            paths.append(p)
    return paths


def read_text_dir(
    directory: str,
    suffix: Optional[str] = ".txt",
    include_all: bool = False,
    encoding: str = "utf-8",
) -> Iterator[Document]:
    """One :class:`Document` per file, ids assigned by sorted path order
    (the deterministic analogue of ``wholeTextFiles`` + ``zipWithIndex``,
    LDAClustering.scala:113,132)."""
    for i, p in enumerate(list_books(directory, suffix, include_all)):
        with open(p, "r", encoding=encoding, errors="replace") as f:
            yield Document(doc_id=i, path=p, text=f.read())


def read_stop_word_file(path: str, encoding: str = "utf-8") -> List[str]:
    """Stop-word files are a single comma-separated line
    (resources/stopWords_EN.txt; read via sc.textFile at
    LDATraining.scala:19-20)."""
    with open(path, "r", encoding=encoding, errors="replace") as f:
        return f.read().splitlines()
