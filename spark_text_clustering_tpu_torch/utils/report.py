"""Human-readable scoring report: the reference's
``TestOutput/Result_<lang>_<millis>`` format.

  * header: k topics, each with its top-weighted terms (term \\t weight)
  * per book: number, name (',' escaped to '?'), the full topic
    distribution, the argmax topic, and "most important words": the top
    100 doc terms by weight that are also among the topic's top 300
    terms, first 10 printed
  * a trailing topic summary with books per topic.

Numbers are formatted like Java's ``Double.toString`` so a report diffs
cleanly against the reference's and the JAX package's, byte for byte.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["java_double_str", "format_scoring_report", "write_scoring_report"]

_BAR = "*" * 87
_HASH = "#" * 87
_DASH = "-" * 55


def java_double_str(x: float) -> str:
    """Java ``Double.toString`` look-alike: decimal for 1e-3 <= |x| < 1e7,
    otherwise scientific with a bare E exponent."""
    if x != x:  # NaN
        return "NaN"
    if x == 0.0:
        return "0.0"
    ax = abs(x)
    if 1e-3 <= ax < 1e7:
        s = repr(float(x))
        if "e" in s or "E" in s:
            # python switched to scientific inside java's decimal range
            # (happens just under 1e-3 boundaries); expand it
            s = f"{x:.17f}".rstrip("0")
            if s.endswith("."):
                s += "0"
        return s
    # scientific: derive mantissa digits from the shortest repr STRING so the
    # last digit is never perturbed by a float divide
    s = repr(float(x))
    sign = "-" if s.startswith("-") else ""
    s = s.lstrip("-")
    if "e" in s:
        m, e = s.split("e")
        if "." not in m:
            m += ".0"
        return f"{sign}{m}E{int(e)}"
    int_part, _, frac = s.partition(".")
    digits = (int_part + frac).lstrip("0")
    if int_part not in ("", "0"):
        exp = len(int_part) - 1
    else:
        exp = -(len(frac) - len(frac.lstrip("0")) + 1)
    digits = digits.rstrip("0") or "0"
    mant = digits[0] + "." + (digits[1:] or "0")
    return f"{sign}{mant}E{exp}"


def _book_display_name(path_or_name: str) -> str:
    """Basename with ',' -> '?' (LDALoader.scala:81's escaping, visible in
    the golden reports)."""
    return os.path.basename(path_or_name).replace(",", "?")


def format_scoring_report(
    model,
    book_names: Sequence[str],
    distributions: np.ndarray,          # [n_books, k]
    book_rows: Sequence[Tuple[np.ndarray, np.ndarray]],
    header_terms: int = 8,
    important_pool: int = 100,
    topic_pool: int = 300,
    important_shown: int = 10,
) -> str:
    """Build the full report text (see module docstring for provenance)."""
    k = model.k
    lines: List[str] = []

    # --- header: top-weighted terms per topic (LDALoader.scala:66-78) ---
    lines += [_BAR, f"LDA Model: {k} Topics", _BAR]
    topics_terms = model.describe_topics_terms(header_terms)
    # ONE ordered top-`topic_pool` pass serves the per-book intersection
    # sets AND the trailing summary's top-10 prefix
    topics_pool_terms = model.describe_topics_terms(topic_pool)
    topic_top_sets = [{t for t, _ in topic} for topic in topics_pool_terms]
    for i, topic in enumerate(topics_terms):
        lines.append(f"TOPIC {i}: top-weighted terms")
        for term, w in topic:
            lines.append(f"{term}\t{java_double_str(w)}")
        lines.append("")
    lines.append(_BAR)

    # --- per book (LDALoader.scala:110-169) -----------------------------
    mains: List[int] = []
    for b, (name, dist, (ids, wts)) in enumerate(
        zip(book_names, distributions, book_rows)
    ):
        lines += [
            _HASH,
            f"Book's number: {b}",
            f"Book's name: {_book_display_name(name)}",
            "",
            _DASH,
            "Topics Nr. \t|\t Distribution",
            _DASH,
        ]
        for t in range(k):
            lines.append(f"Nr.: {t} \t\t|\t {java_double_str(float(dist[t]))}")
        main = int(np.argmax(dist))
        mains.append(main)
        lines.append(
            f"Main topic of the book: Topic Nr. ({main}), "
            f"Weight ({java_double_str(float(dist[main]))})"
        )
        # most important words: top-`important_pool` doc terms by TF desc,
        # intersected with the topic's top-`topic_pool` terms
        # (LDALoader.scala:86-94,154-164)
        order = np.argsort(-np.asarray(wts), kind="stable")[:important_pool]
        doc_terms = [model.vocab[int(ids[j])] for j in order]
        important = [t for t in doc_terms if t in topic_top_sets[main]]
        lines += [
            "Book most important words",
            _DASH,
            "Word. \t|\t TF",
            _DASH,
            "".join(f"{t}, " for t in important[:important_shown]),
            _HASH,
            "",
        ]

    # --- trailing topic summary (LDALoader.scala:171-206): top-10 terms
    # per topic + books-per-topic tallies and name lists.  The name list
    # reproduces the reference's accumulator formatting exactly: each name
    # followed by ", ", except every 3rd book in a topic ends its line.
    # (Absent from the two frozen golden reports — they predate this
    # section of the reference code — so parity parsers treat it as an
    # optional tail.)
    topic_counts = [0] * k
    topic_names = [""] * k
    for name, main in zip(book_names, mains):
        topic_counts[main] += 1
        topic_names[main] += _book_display_name(name)
        topic_names[main] += "\n" if topic_counts[main] % 3 == 0 else ", "
    lines += [_BAR, "List of topics", _BAR]
    for i in range(k):
        lines += [_DASH, f"TOPIC {i}: top-weighted terms", _DASH]
        lines += [
            f"{term}\t{java_double_str(w)}"
            for term, w in topics_pool_terms[i][:10]
        ]
        lines += [
            "",
            _DASH,
            f"Amount of books in the topic: {topic_counts[i]}",
            _DASH,
            "List of Books:",
            _DASH,
            topic_names[i],
            _DASH,
            "",
        ]
    lines += [_BAR, "", _HASH]
    return "\n".join(lines)


def write_scoring_report(
    text: str,
    output_dir: str,
    lang: str,
    timestamp_millis: Optional[int] = None,
    filename: Optional[str] = None,
) -> str:
    """Write to ``<output_dir>/Result_<lang>_<millis>`` atomically (tmp +
    rename) and retried under the I/O policy (fault site
    ``report.write``): a report exists complete or not at all.
    ``filename`` overrides the timestamped name (a ledgered stream's
    ``Result_<lang>_epoch-<n>``, the same file again on a resumed run)."""
    from ..resilience import atomic_write_text, faultinject, retry_call

    if filename is None:
        ts = (
            timestamp_millis if timestamp_millis is not None
            else int(time.time() * 1000)
        )
        filename = f"Result_{lang}_{ts}"
    path = os.path.join(output_dir, filename)

    def _write() -> None:
        faultinject.check("report.write")
        os.makedirs(output_dir, exist_ok=True)
        atomic_write_text(path, text)

    retry_call(_write, site="report.write")
    return path
