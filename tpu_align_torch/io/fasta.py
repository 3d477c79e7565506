"""FASTA ingestion: external sequence files -> the 3-line pair format
(the port's copy of tpu_align/io/fasta.py).

The reference's real benchmark input was derived from an SRA run
(bandedSWA_SRR7733443_100k_input.txt, c++/Makefile:4; the file itself is
LFS-absent upstream) through a shell pipeline that paired consecutive
reads and translated the digit alphabet "0123" to "ATCG"
(cuda/convert.sh, web-scraper.py:5-12).  This module is the supported
ingestion path for that workflow: parse a FASTA dump (as produced by
sra-tools' fasta-dump: '>' headers, sequence wrapped over multiple
lines, possibly CRLF), pair consecutive reads (read 2k aligns against
read 2k+1), and emit the 3-line pair format that ta_parse_pairs /
PairDataset.from_file consume.

Digit-alphabet sequences are passed through verbatim here -- the pair
parser itself performs the 0123->ATCG translation (io/dataset.py), so a
digit FASTA and a letter FASTA of the same reads produce identical
datasets.
"""

from __future__ import annotations

import numpy as np


def read_fasta(path: str) -> list[tuple[str, bytes]]:
    """Parse a FASTA file into [(header, sequence bytes)].

    Tolerates CRLF and classic Mac CR line endings, multi-line wrapped
    sequences, lowercase bases (upcased), and blank lines.  Raises
    ValueError on content before the first header or an empty record.
    """
    with open(path, "rb") as f:
        raw = f.read()
    records: list[tuple[str, bytes]] = []
    header = None
    chunks: list[bytes] = []

    def flush():
        if header is None:
            return
        seq = b"".join(chunks).upper()
        if not seq:
            raise ValueError(f"empty FASTA record: {header!r}")
        records.append((header, seq))

    for line in raw.replace(b"\r\n", b"\n").replace(b"\r", b"\n").split(b"\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            flush()
            header = line[1:].decode("ascii", "replace").strip()
            chunks = []
        elif header is None:
            raise ValueError("sequence data before the first '>' header")
        else:
            chunks.append(line)
    flush()
    return records


def fasta_to_pairfile(fasta_path: str, out_path: str,
                      queries_path: str | None = None) -> int:
    """Write the 3-line pair file (seed line, reference, query) from FASTA.

    Single-file mode pairs consecutive reads: read 2k is the reference
    for query read 2k+1 (a trailing unpaired read is dropped).  With
    queries_path, file k-th records pair positionally (ref[k], qry[k]).
    The seed line carries the source read headers.  Returns the number
    of pairs written."""
    recs = read_fasta(fasta_path)
    if queries_path is not None:
        qrecs = read_fasta(queries_path)
        if len(recs) != len(qrecs):
            # a count mismatch in positionally-paired files is a data
            # error; silently dropping the tail would hide missing reads
            raise ValueError(
                f"reference/query FASTA record counts differ: "
                f"{len(recs)} in {fasta_path!r} vs {len(qrecs)} in "
                f"{queries_path!r}")
        pairs = list(zip(recs, qrecs))
    else:
        pairs = [(recs[2 * k], recs[2 * k + 1]) for k in range(len(recs) // 2)]
    with open(out_path, "wb") as f:
        for (rh, rs), (qh, qs) in pairs:
            f.write(f"{rh} :: {qh}\n".encode("ascii", "replace"))
            f.write(rs + b"\n")
            f.write(qs + b"\n")
    return len(pairs)


def score_checksum(scores) -> str:
    """Order-independent checksum of a run's pair scores (hex), for
    recording alongside ingested-dataset runs."""
    import hashlib

    arr = np.sort(np.asarray(scores, np.int64))
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]
