"""ALS input preparation: parse → decay → aggregate → index.

Host-side equivalent of the reference's ALSUpdate input pipeline
(app/oryx-app-mllib/.../als/ALSUpdate.java:326-423): CSV/JSON lines
``user,item,strength[,timestamp]`` with empty strength = delete (NaN);
time-decay of ratings (decayRating:383-389, ``oryx.als.decay.*``);
aggregation — implicit: NaN-aware sum per (user,item) (delete wins the pair),
explicit: last-by-timestamp wins (aggregateScores:395-423); optional
``log1p(v/epsilon)`` strength scaling; and string-ID → dense-index maps
(buildIDIndexMapping:181-190) built with host dictionaries instead of a
Spark zipWithIndex shuffle.

Output is a COO batch of (row, col, value) numpy arrays sorted by row,
ready to ship to the device trainer.

Host numpy, copied bit for bit from the reference ``oryx_tpu`` package's
``models/als/data.py`` (the port imports nothing of it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from oryx_tpu_torch.common import textutils


@dataclass
class Interaction:
    user: str
    item: str
    value: float  # NaN = delete
    timestamp_ms: int


def parse_line(line: str, now_ms: int | None = None) -> Interaction:
    """user,item[,strength[,ts]]; empty strength = delete → NaN."""
    tokens = textutils.parse_possibly_json(line)
    if len(tokens) < 2:
        raise ValueError(f"bad ALS input: {line!r}")
    user, item = tokens[0], tokens[1]
    if len(tokens) >= 3:
        value = float("nan") if tokens[2] == "" else float(tokens[2])
    else:
        value = 1.0
    ts = int(float(tokens[3])) if len(tokens) >= 4 else (now_ms or int(time.time() * 1000))
    return Interaction(user, item, value, ts)


def parse_lines(lines: Iterable[str], now_ms: int | None = None) -> list[Interaction]:
    import csv as _csv

    out = []
    for line in lines:
        try:
            out.append(parse_line(line, now_ms))
        except (ValueError, IndexError, OverflowError, _csv.Error):
            import logging

            logging.getLogger(__name__).warning("bad input: %s", line)
    return out


def decay(
    interactions: Sequence[Interaction],
    factor: float,
    zero_threshold: float,
    now_ms: int | None = None,
) -> list[Interaction]:
    """Exponential per-day decay + threshold filter (decayRating:383-389)."""
    if factor >= 1.0 and zero_threshold <= 0.0:
        return list(interactions)
    now_ms = now_ms or int(time.time() * 1000)
    out = []
    for it in interactions:
        v = it.value
        if factor < 1.0 and it.timestamp_ms < now_ms and not np.isnan(v):
            days = (now_ms - it.timestamp_ms) / 86400000.0
            v = v * factor**days
        if zero_threshold > 0.0 and not np.isnan(v) and v <= zero_threshold:
            continue
        out.append(Interaction(it.user, it.item, v, it.timestamp_ms))
    return out


def aggregate(
    interactions: Sequence[Interaction],
    implicit: bool,
    log_strength: bool = False,
    epsilon: float = 1.0e-5,
) -> dict[tuple[str, str], float]:
    """Combine per (user,item): implicit = NaN-aware sum (NaN anywhere deletes
    the pair), explicit = last (by timestamp order) wins; then drop NaN and
    apply optional log scaling (aggregateScores:395-423)."""
    ordered = sorted(interactions, key=lambda it: it.timestamp_ms)
    agg: dict[tuple[str, str], float] = {}
    if implicit:
        for it in ordered:
            k = (it.user, it.item)
            if np.isnan(it.value):
                agg[k] = float("nan")
            else:
                cur = agg.get(k)
                if cur is None:
                    agg[k] = it.value
                elif not np.isnan(cur):
                    agg[k] = cur + it.value
                # cur NaN: delete sticks for this batch (SUM_WITH_NAN)
    else:
        for it in ordered:
            agg[(it.user, it.item)] = it.value
    result = {k: v for k, v in agg.items() if not np.isnan(v)}
    if log_strength:
        result = {k: float(np.log1p(v / epsilon)) for k, v in result.items()}
    return result


class IDIndexMapping:
    """Bidirectional string-ID ↔ dense-index maps for one axis
    (buildIDIndexMapping:181-190; sorted for determinism)."""

    def __init__(self, ids: Iterable[str]):
        self.index_to_id: list[str] = sorted(set(ids))
        self.id_to_index: dict[str, int] = {s: i for i, s in enumerate(self.index_to_id)}

    @classmethod
    def from_sorted_unique(cls, ids: list) -> "IDIndexMapping":
        """Construct from an already-sorted, already-unique id list (the
        vectorized ingest path) without re-sorting."""
        self = cls.__new__(cls)
        self.index_to_id = list(ids)
        self.id_to_index = {s: i for i, s in enumerate(self.index_to_id)}
        return self

    def __len__(self) -> int:
        return len(self.index_to_id)


@dataclass
class RatingBatch:
    """COO ratings sorted by row, plus the ID maps."""

    rows: np.ndarray  # int32 [nnz]
    cols: np.ndarray  # int32 [nnz]
    vals: np.ndarray  # float32 [nnz]
    users: IDIndexMapping
    items: IDIndexMapping

    @property
    def nnz(self) -> int:
        return len(self.vals)


def build_rating_batch(
    aggregated: dict[tuple[str, str], float],
    users: IDIndexMapping | None = None,
    items: IDIndexMapping | None = None,
) -> RatingBatch:
    if users is None:
        users = IDIndexMapping(u for (u, _i) in aggregated)
    if items is None:
        items = IDIndexMapping(i for (_u, i) in aggregated)
    rows = np.empty(len(aggregated), dtype=np.int32)
    cols = np.empty(len(aggregated), dtype=np.int32)
    vals = np.empty(len(aggregated), dtype=np.float32)
    n = 0
    for (u, i), v in aggregated.items():
        ui = users.id_to_index.get(u)
        ii = items.id_to_index.get(i)
        if ui is None or ii is None:
            continue
        rows[n], cols[n], vals[n] = ui, ii, v
        n += 1
    rows, cols, vals = rows[:n], cols[:n], vals[:n]
    order = np.argsort(rows, kind="stable")
    return RatingBatch(rows[order], cols[order], vals[order], users, items)


def _unique_inverse(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(return_inverse) for id strings, via pandas' hash-based
    factorize when available (~2× numpy's sort-based unique at 1M ids;
    identical outputs with sort=True)."""
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover — pandas is in the base image
        return np.unique(arr, return_inverse=True)
    codes, cats = pd.factorize(arr, sort=True)
    return np.asarray(cats), codes


def _tokenize_uniform(lines: list, now_s: str):
    """Whole-corpus tokenization for the uniform plain-CSV case: ONE join,
    ONE split, and strided list slices instead of a million per-line
    ``str.split`` calls (which were ~75% of vectorized-ingest wall).

    Applies only when a blob scan shows no quotes, no brackets, and no CRs
    anywhere AND every line has the same field count (detected by exact
    token-count arithmetic); anything else returns None and the per-line
    tokenizer decides. Returns (users, items, vals, tss) lists or None."""
    import itertools

    n = len(lines)
    first = lines[0]
    if not first:
        return None
    k = first.count(",") + 1
    if k not in (2, 3, 4):
        return None
    # EVERY line must have exactly k-1 commas (one C-level map — aggregate
    # token arithmetic alone can be fooled by offsetting raggedness, e.g. a
    # 4-field and a 2-field line summing to 2·3 tokens and silently
    # misaligning every row after the first irregular one)
    if set(map(str.count, lines, itertools.repeat(","))) != {k - 1}:
        return None
    blob = "\n".join(lines)
    if '"' in blob or "[" in blob or "\r" in blob:
        return None
    if blob.count("\n") != n - 1:
        return None  # embedded newline inside some line
    parts = blob.replace("\n", ",").split(",")
    if len(parts) != n * k:
        return None  # unreachable given the checks above; belt and braces
    users = parts[0::k]
    items = parts[1::k]
    if k == 2:
        return users, items, ["1"] * n, [now_s] * n
    vals = parts[2::k]
    if "" in vals:
        vals = [x or "nan" for x in vals]  # empty strength → NaN (delete)
    if k == 3:
        return users, items, vals, [now_s] * n
    tss = parts[3::k]
    if "" in tss:
        return None  # empty ts is a parse error (skipped) downstream
    return users, items, vals, tss


def _tokenize_per_line(lines: list, now_s: str):
    """Per-line tokenizer for mixed/edge CSV that is still plain (no JSON,
    no quoting): the original vectorized-ingest loop."""
    users: list = []
    items: list = []
    vals: list = []
    tss: list = []
    for ln in lines:
        if ln and ln[-1] in "\r\n":
            ln = ln.rstrip("\r\n")  # the csv parser strips line terminators
        if not ln or ln[0] == "[" or '"' in ln:
            return None
        if ln[0].isspace() and ln.lstrip()[:1] == "[":
            return None  # JSON sniffing strips leading whitespace downstream
        t = ln.split(",")
        nt = len(t)
        if nt == 3:
            users.append(t[0]); items.append(t[1])
            vals.append(t[2] or "nan"); tss.append(now_s)
        elif nt == 4:
            if not t[3]:
                return None  # empty ts is a parse error (skipped) downstream
            users.append(t[0]); items.append(t[1])
            vals.append(t[2] or "nan"); tss.append(t[3])
        elif nt == 2:
            users.append(t[0]); items.append(t[1])
            vals.append("1"); tss.append(now_s)
        else:
            return None
    return users, items, vals, tss


def _prepare_vectorized(
    lines: list,
    implicit: bool,
    decay_factor: float,
    decay_zero_threshold: float,
    log_strength: bool,
    epsilon: float,
    now_ms: int,
) -> "RatingBatch | None":
    """Vectorized ingest for the common plain-CSV case — the data-loader hot
    path at reference scale (25M-row MovieLens ingest takes minutes through
    per-line Interaction objects and dict aggregation; this is one tokenize
    pass plus numpy unique/lexsort/reduceat group-bys with IDENTICAL
    semantics to parse→decay→aggregate). Returns None when any line needs
    the general parser (JSON arrays, quoted CSV, bad lines) — the caller
    then replays the whole batch through the slow path."""
    if not lines:
        return None
    now_s = str(now_ms)
    fast = _tokenize_uniform(lines, now_s)
    if fast is not None:
        users, items, vals, tss = fast
    else:
        slow = _tokenize_per_line(lines, now_s)
        if slow is None:
            return None
        users, items, vals, tss = slow
    try:
        v = np.asarray(vals, dtype=np.float64)
        tsf = np.asarray(tss, dtype=np.float64)
    except ValueError:
        return None  # non-numeric strength/timestamp → general parser
    if not np.isfinite(tsf).all() or not (np.abs(tsf) < 2.0**63).all():
        # 'nan'/'inf' are parse errors downstream; >= 2^63 would wrap in the
        # int64 cast and invert last-by-timestamp ordering
        return None
    ts = tsf.astype(np.int64)

    # decay (decayRating:383-389): per-day exponential for past timestamps
    if decay_factor < 1.0:
        days = (now_ms - ts) / 86400000.0
        live = ~np.isnan(v) & (ts < now_ms)
        v = np.where(live, v * decay_factor ** np.maximum(days, 0.0), v)
    if decay_zero_threshold > 0.0:
        keep = np.isnan(v) | (v > decay_zero_threshold)
        v, ts = v[keep], ts[keep]
        users = np.asarray(users, dtype=object)[keep]
        items = np.asarray(items, dtype=object)[keep]
    if len(v) == 0:
        return RatingBatch(
            np.empty(0, np.int32), np.empty(0, np.int32),
            np.empty(0, np.float32),
            IDIndexMapping(()), IDIndexMapping(()),
        )

    uid_sorted, uinv = _unique_inverse(np.asarray(users, dtype=object))
    iid_sorted, iinv = _unique_inverse(np.asarray(items, dtype=object))
    key = uinv.astype(np.int64) * len(iid_sorted) + iinv

    if implicit:
        # SUM_WITH_NAN per pair: a plain group-sum reproduces the delete
        # rule exactly (any NaN poisons the pair's sum)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        agg_key = ks[starts]
        agg_v = np.add.reduceat(v[order], starts)
    else:
        # explicit: last write in timestamp order wins (ties → input order)
        order = np.lexsort((np.arange(len(key)), ts, key))
        ks = key[order]
        last = np.flatnonzero(np.r_[ks[1:] != ks[:-1], True])
        agg_key = ks[last]
        agg_v = v[order][last]

    keep = ~np.isnan(agg_v)
    agg_key, agg_v = agg_key[keep], agg_v[keep]
    if log_strength:
        agg_v = np.log1p(agg_v / epsilon)

    rows64 = agg_key // len(iid_sorted)
    cols64 = agg_key % len(iid_sorted)
    # re-index over only the ids that SURVIVE aggregation (deleted-only ids
    # must not appear in the mappings — build_rating_batch semantics)
    su = np.unique(rows64)
    si = np.unique(cols64)
    rows = np.searchsorted(su, rows64).astype(np.int32)
    cols = np.searchsorted(si, cols64).astype(np.int32)
    users_map = IDIndexMapping.from_sorted_unique(uid_sorted[su].tolist())
    items_map = IDIndexMapping.from_sorted_unique(iid_sorted[si].tolist())
    final = np.argsort(rows, kind="stable")  # COO sorted by row
    return RatingBatch(
        rows[final], cols[final], agg_v[final].astype(np.float32),
        users_map, items_map,
    )


def prepare(
    lines: Iterable[str],
    implicit: bool,
    decay_factor: float = 1.0,
    decay_zero_threshold: float = 0.0,
    log_strength: bool = False,
    epsilon: float = 1.0e-5,
    now_ms: int | None = None,
) -> RatingBatch:
    """Full pipeline: parse → decay → aggregate → index → COO. Plain-CSV
    input takes the vectorized fast path; JSON/quoted/bad lines fall back to
    the general per-line parser."""
    lines = list(lines)
    now = now_ms or int(time.time() * 1000)
    fast = _prepare_vectorized(
        lines, implicit, decay_factor, decay_zero_threshold, log_strength,
        epsilon, now,
    )
    if fast is not None:
        return fast
    interactions = parse_lines(lines, now)
    interactions = decay(interactions, decay_factor, decay_zero_threshold, now)
    agg = aggregate(interactions, implicit, log_strength, epsilon)
    return build_rating_batch(agg)
