r"""Pure-Python GenBank flat-file parser.

Replaces the reference's Rust ``gb-io`` wheel (used at
``kaptive/db/core.py:320,344-441``) for database
compilation — a host-side, offline, one-time step, so a clear Python parser is
the right tool.  Supports the subset of GenBank needed by locus databases:
LOCUS name, feature table with qualifiers (multi-line continuations), simple /
``complement(...)`` / ``join(...)`` locations with partial markers, and the
ORIGIN sequence block.
"""

from __future__ import annotations

import re
from collections.abc import Iterator
from dataclasses import dataclass, field
from typing import IO, NamedTuple


class Qualifier(NamedTuple):
    key: str
    value: str


@dataclass(slots=True)
class Location:
    start: int  # 0-based inclusive
    end: int  # 0-based exclusive
    strand: int  # +1 / -1


@dataclass(slots=True)
class Feature:
    kind: str
    location: Location
    qualifiers: list[Qualifier] = field(default_factory=list)


@dataclass(slots=True)
class Record:
    name: str
    sequence: bytes
    features: list[Feature] = field(default_factory=list)


_LOCATION_SPAN = re.compile(r"[<>]?(\d+)\.\.[<>]?(\d+)")
_SINGLE_POS = re.compile(r"^[<>]?(\d+)$")


def parse_location(text: str) -> Location:
    r"""Parse a GenBank location string into a 0-based half-open span + strand.

    ``join(...)`` collapses to the bounding span (the reference also sorts the
    feature span to (min, max), ``db/core.py:403``).
    """
    strand = 1
    t = text.strip()
    # Unwrap nested complement()/join()/order() operators.
    changed = True
    while changed:
        changed = False
        for op in ("complement", "join", "order"):
            if t.startswith(op + "(") and t.endswith(")"):
                if op == "complement":
                    strand = -strand
                t = t[len(op) + 1 : -1]
                changed = True
    spans = _LOCATION_SPAN.findall(t)
    if spans:
        starts = [int(s) for s, _ in spans]
        ends = [int(e) for _, e in spans]
        return Location(min(starts) - 1, max(ends), strand)
    m = _SINGLE_POS.match(t)
    if m:
        p = int(m.group(1))
        return Location(p - 1, p, strand)
    raise ValueError(f"Unsupported GenBank location: {text!r}")


def iter_records(handle: IO[bytes]) -> Iterator[Record]:
    r"""Iterate records in a GenBank flat file (binary handle)."""
    name = ""
    features: list[Feature] = []
    seq_parts: list[bytes] = []
    state = "head"  # head | features | origin
    cur_feature: Feature | None = None
    cur_qual_key: str | None = None
    cur_qual_val: list[str] = []
    cur_loc_text: str = ""
    pending_location = False

    def flush_qualifier():
        nonlocal cur_qual_key, cur_qual_val
        if cur_feature is not None and cur_qual_key is not None:
            val = "".join(cur_qual_val)
            if val.startswith('"') and val.endswith('"'):
                val = val[1:-1]
            cur_feature.qualifiers.append(Qualifier(cur_qual_key, val))
        cur_qual_key = None
        cur_qual_val = []

    def flush_feature():
        nonlocal cur_feature, pending_location, cur_loc_text
        flush_qualifier()
        if cur_feature is not None and pending_location:
            cur_feature.location = parse_location(cur_loc_text)
            pending_location = False
        if cur_feature is not None:
            features.append(cur_feature)
        cur_feature = None

    for raw in handle:
        line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
        if line.startswith("//"):
            flush_feature()
            yield Record(name, b"".join(seq_parts).upper(), features)
            name, features, seq_parts, state = "", [], [], "head"
            continue
        if line.startswith("LOCUS"):
            parts = line.split()
            name = parts[1] if len(parts) > 1 else ""
            state = "head"
            continue
        if line.startswith("FEATURES"):
            state = "features"
            continue
        if line.startswith("ORIGIN"):
            flush_feature()
            state = "origin"
            continue
        if state == "features":
            if len(line) > 5 and line[:5] == "     " and line[5] != " ":
                # New feature line: kind at col 5, location from col 21.
                flush_feature()
                kind = line[5:21].strip()
                loc_text = line[21:].strip()
                cur_feature = Feature(kind, Location(0, 0, 1))
                cur_loc_text = loc_text
                pending_location = True
            elif line[:21].strip() == "" and len(line) > 21:
                content = line[21:]
                # A '/' only starts a NEW qualifier when the current quoted
                # value is closed: a wrapped value whose continuation line
                # happens to begin with '/' must keep accumulating, or the
                # value is truncated and a bogus qualifier fabricated.
                in_open_quote = (
                    cur_qual_key is not None
                    and "".join(cur_qual_val).count('"') % 2 == 1
                )
                if content.startswith("/") and not in_open_quote:
                    # New qualifier.
                    flush_qualifier()
                    if pending_location and cur_feature is not None:
                        cur_feature.location = parse_location(cur_loc_text)
                        pending_location = False
                    body = content[1:]
                    if "=" in body:
                        key, _, val = body.partition("=")
                        cur_qual_key = key
                        cur_qual_val = [val.strip()]
                    else:
                        cur_qual_key = body
                        cur_qual_val = [""]
                elif pending_location:
                    cur_loc_text += content.strip()
                elif cur_qual_key is not None:
                    # Continuation: GenBank wraps long values; translations join
                    # without spaces, prose joins with a space.
                    prev = "".join(cur_qual_val)
                    sep = "" if cur_qual_key == "translation" else " "
                    cur_qual_val = [prev + sep + content.strip()] if prev else [content.strip()]
        elif state == "origin":
            seq_parts.append(
                bytes(c for c in line.encode() if (65 <= c <= 90) or (97 <= c <= 122))
            )
    # Tolerate a missing trailing // terminator.
    if name or features or seq_parts:
        flush_feature()
        yield Record(name, b"".join(seq_parts).upper(), features)


def write_genbank(records: list[Record]) -> bytes:
    r"""Render records back to GenBank text (round-trip aid for tests/fixtures)."""
    out: list[str] = []
    for rec in records:
        out.append(f"LOCUS       {rec.name} {len(rec.sequence)} bp    DNA     linear   UNA")
        out.append("FEATURES             Location/Qualifiers")
        for feat in rec.features:
            loc = f"{feat.location.start + 1}..{feat.location.end}"
            if feat.location.strand < 0:
                loc = f"complement({loc})"
            out.append(f"     {feat.kind:<16}{loc}")
            for q in feat.qualifiers:
                out.append(f'                     /{q.key}="{q.value}"')
        out.append("ORIGIN")
        seq = rec.sequence.decode()
        for i in range(0, len(seq), 60):
            chunk = seq[i : i + 60]
            grouped = " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10))
            out.append(f"{i + 1:>9} {grouped.lower()}")
        out.append("//")
    return ("\n".join(out) + "\n").encode()
