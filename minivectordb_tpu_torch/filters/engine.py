"""Mongo-like metadata filter engine (single shared implementation).

The reference duplicates this logic verbatim in all three database classes
(vector_database.py:157-386, sharded_vector_database.py:289-518,
sharded_vector_database_usearch.py:287-516). Here it is implemented once and
shared by the flat and sharded engines.

Observable semantics preserved from the reference:
- ``metadata_filter`` (dict or list of dicts) is an AND across all key/value
  pairs (vector_database.py:238-318).
- ``or_filters`` is a union across its dicts, then *intersected* with the AND
  result (vector_database.py:366-377).
- ``exclude_filter`` subtracts matches and supports equality only — operator
  dicts in an exclude compare literally and thus never match
  (vector_database.py:320-352).
- Operators: $gt $gte $lt $lte $ne, and $in meaning "filter value is a member
  of the metadata value" (vector_database.py:166-173). Unknown operators raise
  ValueError (vector_database.py:174-175).
- Empty-dict filters are falsy and mean "no filter" (vector_database.py:354-356).

Deliberate fix vs. the reference (documented quirk, SURVEY.md C4): when one
key maps to a dict of several operators, e.g. ``{"$gte": a, "$lte": b}``, the
reference silently applies only the first (vector_database.py:164,243); here
ALL operators in the dict are applied (AND within the key — proper range
queries). Every reference test still passes under this semantics.

Performance: equality lookups use a (key, value) -> uids value-level index
maintained incrementally (falling back to a scan of the key's posting list
for unhashable values), instead of the reference's full iteration over the
key posting list per query.
"""

from __future__ import annotations

import datetime
import operator
from collections import defaultdict
from typing import Any, Iterable

import numpy as np

_OPS = {
    "$gt": operator.gt,
    "$gte": operator.ge,
    "$lt": operator.lt,
    "$lte": operator.le,
    "$ne": operator.ne,
    # reference vector_database.py:172 — op_func(metadata_value, filter_value)
    "$in": lambda metadata_value, filter_value: filter_value in metadata_value,
}


def _op_func(op: str):
    fn = _OPS.get(op)
    if fn is None:
        raise ValueError(f"Invalid operator: {op}")
    return fn


# ---------------------------------------------------------------------------
# Row-aligned value columns: vectorized $gt/$gte/$lt/$lte/$ne evaluation.
#
# The reference walks every uid in the key's posting list through a Python
# loop per operator query (reference vector_database.py:238-318) — O(posting
# list) interpreter work per query, ~1 s-class at 1M rows. Here the engine
# maintains a float64 column + presence mask per metadata key (numbers,
# datetimes, dates); an operator query is then a numpy broadcast compare over
# the column — microseconds at 1M rows.
#
# Parity rules (the fast path only fires when it is bit-for-bit equivalent to
# the reference's Python-loop semantics, else it falls back):
# - A column is usable only while EVERY stored value under the key has one
#   comparison kind: all numerics (bool/int/float, ints within +-2^53 so
#   float64 is exact), all naive datetimes, all aware datetimes, or all
#   dates. Any other/mixed value poisons the column -> Python fallback,
#   which raises TypeError on incomparable pairs exactly as the reference's
#   `operator.gt(value, filter_value)` would.
# - The filter value must classify to the SAME kind (naive-vs-aware datetime
#   mismatch falls back so Python raises, matching the reference).
# - $in and unknown operators always take the fallback (unknown ops raise
#   ValueError there, reference vector_database.py:174-175).
# ---------------------------------------------------------------------------

_NP_OPS = {
    "$gt": np.greater,
    "$gte": np.greater_equal,
    "$lt": np.less,
    "$lte": np.less_equal,
    "$ne": np.not_equal,
}

_MAX_EXACT_INT = 1 << 53  # |int| above this is not exact in float64
_COMPARABLE_KINDS = ("num", "dt_naive", "dt_aware", "date")
_NAIVE_EPOCH = datetime.datetime(1970, 1, 1)  # naive-datetime encoding origin


def _classify(v):
    """(kind, float64 encoding) for a comparable value, else ('other', None).

    Encodings are strictly monotone within each kind (timestamps for
    datetimes, ordinals for dates), so numpy ordering == Python ordering."""
    if isinstance(v, bool):
        return "num", float(v)
    if isinstance(v, int):
        if -_MAX_EXACT_INT <= v <= _MAX_EXACT_INT:
            return "num", float(v)
        return "other", None
    if isinstance(v, float):
        return "num", v
    if isinstance(v, datetime.datetime):  # before date: datetime subclasses it
        if v.tzinfo is not None:
            return "dt_aware", v.timestamp()
        # naive: NEVER .timestamp() — it interprets the value in the host's
        # local timezone, which is non-monotone across DST gaps (two wall
        # times one hour apart encode equal) and raises OSError pre-1970 on
        # some platforms. Naive epoch arithmetic is TZ-independent, exactly
        # mirrors Python's naive-datetime ordering, and keeps the same
        # float64 scale (so the same sub-microsecond precision) as
        # timestamp().
        return "dt_naive", (v - _NAIVE_EPOCH).total_seconds()
    if isinstance(v, datetime.date):
        return "date", float(v.toordinal())
    return "other", None


class _Column:
    __slots__ = ("kind", "values", "present")

    def __init__(self):
        self.kind = None  # None until first value; 'mixed' = unusable
        self.values: np.ndarray | None = None  # float64, row-aligned
        self.present: np.ndarray | None = None  # bool, row-aligned

    def usable(self) -> bool:
        return self.kind in _COMPARABLE_KINDS and self.values is not None


class ColumnStore:
    """Row-aligned per-key columns, maintained by the engine next to its
    ``metadata`` list. ``count`` mirrors the engine's live row count."""

    __slots__ = ("columns", "count", "_capacity")

    def __init__(self):
        self.columns: dict[Any, _Column] = {}
        self.count = 0
        self._capacity = 0

    def _ensure_capacity(self, need: int) -> None:
        if need <= self._capacity:
            return
        cap = max(64, self._capacity)
        while cap < need:
            cap *= 2
        for col in self.columns.values():
            if col.values is not None:
                v = np.zeros(cap, dtype=np.float64)
                v[: self.count] = col.values[: self.count]
                col.values = v
                p = np.zeros(cap, dtype=bool)
                p[: self.count] = col.present[: self.count]
                col.present = p
        self._capacity = cap

    def _set(self, key, row: int, value) -> None:
        col = self.columns.get(key)
        kind, fv = _classify(value)
        if col is None:
            col = _Column()
            col.kind = kind
            self.columns[key] = col
        elif col.kind != kind:
            col.kind = "mixed"
            col.values = None
            col.present = None
            return
        if col.kind not in _COMPARABLE_KINDS:
            return
        if col.values is None:
            col.values = np.zeros(max(self._capacity, 64), dtype=np.float64)
            col.present = np.zeros(max(self._capacity, 64), dtype=bool)
            if self._capacity == 0:
                self._capacity = 64
        col.values[row] = fv
        col.present[row] = True

    def append(self, metadata: dict) -> None:
        row = self.count
        self._ensure_capacity(row + 1)
        for key, value in metadata.items():
            self._set(key, row, value)
        self.count = row + 1

    def append_many(self, metadatas: Iterable[dict]) -> None:
        for md in metadatas:
            self.append(md)

    def clear_rows(self, rows) -> None:
        """Tombstone rows in place (deferred compaction): clearing
        ``present`` makes every columnar operator mask exclude them, the
        same way removing a uid from the MetadataIndex excludes it from the
        posting-list paths. Row numbering does not shift."""
        if len(rows) == 0:
            return
        idx = np.asarray(rows, dtype=np.int64)
        for col in self.columns.values():
            if col.present is not None:
                col.present[idx] = False

    def delete_rows(self, rows: list[int]) -> None:
        """Compact out sorted row indices (engine rows compact on delete)."""
        if not rows:
            return
        keep = np.ones(self.count, dtype=bool)
        keep[rows] = False
        new_count = int(keep.sum())
        for col in self.columns.values():
            if col.values is not None:
                col.values = col.values[: self.count][keep]
                col.present = col.present[: self.count][keep]
        self.count = new_count
        self._capacity = new_count

    def rebuild(self, metadatas: Iterable[dict]) -> None:
        self.columns = {}
        self.count = 0
        self._capacity = 0
        self.append_many(metadatas)

    # -- query -------------------------------------------------------------

    def op_mask(self, key, opdict: dict) -> np.ndarray | None:
        """Row mask for an operator dict over ``key``, or None when the
        columnar fast path cannot reproduce reference semantics exactly."""
        col = self.columns.get(key)
        if col is None:
            # key never stored -> no row has it -> empty match (exact parity:
            # the posting list is empty so the reference loop matches nothing)
            if "$in" in opdict:
                return None  # $in stays on the fallback path uniformly
            for op in opdict:
                if op not in _NP_OPS:
                    return None  # unknown op must raise in the fallback
            return np.zeros(self.count, dtype=bool)
        if not col.usable():
            return None
        n = self.count
        mask = col.present[:n].copy()
        vals = col.values[:n]
        for op, opv in opdict.items():
            fn = _NP_OPS.get(op)
            if fn is None:
                return None  # $in or unknown -> fallback
            kind, fv = _classify(opv)
            if kind != col.kind:
                return None  # type mismatch -> fallback (raises like the ref)
            mask &= fn(vals, fv)
        return mask


# -- set/mask combination helpers -------------------------------------------
# Candidate collections flow through the evaluator as either a Python set of
# rows or a row-aligned numpy bool mask; these keep the algebra uniform.


def _is_empty(x) -> bool:
    if x is None:
        return False
    if isinstance(x, set):
        return not x
    return not x.any()


def _and_combine(a, b):
    if isinstance(a, set) and isinstance(b, set):
        return a & b
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a & b
    s, m = (a, b) if isinstance(a, set) else (b, a)
    return {r for r in s if r < m.shape[0] and m[r]}


def _or_combine(a, b):
    if isinstance(a, set) and isinstance(b, set):
        return a | b
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a | b
    s, m = (a, b) if isinstance(a, set) else (b, a)
    out = m.copy()
    if s:
        out[np.fromiter(s, dtype=np.int64, count=len(s))] = True
    return out


def _sub_set(a, s: set):
    """a minus a set of rows."""
    if isinstance(a, set):
        return a - s
    out = a.copy()
    if s:
        idx = np.fromiter(s, dtype=np.int64, count=len(s))
        idx = idx[idx < out.shape[0]]
        out[idx] = False
    return out


class MetadataIndex:
    """Host-side metadata store: posting lists + value-level equality index.

    The uid-keyed structures mirror the reference's public ``inverted_index``
    (key -> set of uids); the value index is an internal acceleration layer.
    """

    def __init__(self):
        self.inverted_index: defaultdict[Any, set] = defaultdict(set)
        # key -> value -> set(uids); only hashable values land here.
        self._value_index: dict[Any, dict[Any, set]] = {}
        # key -> set(uids) whose value under key is unhashable (list, dict...)
        self._unhashable: dict[Any, set] = {}

    # -- maintenance -------------------------------------------------------

    def add(self, uid, metadata: dict) -> None:
        for key, value in metadata.items():
            self.inverted_index[key].add(uid)
            try:
                self._value_index.setdefault(key, {}).setdefault(value, set()).add(uid)
            except TypeError:
                self._unhashable.setdefault(key, set()).add(uid)

    def remove(self, uid, metadata: dict) -> None:
        for key, value in metadata.items():
            s = self.inverted_index.get(key)
            if s is not None:
                s.discard(uid)
                if not s:
                    del self.inverted_index[key]
            vi = self._value_index.get(key)
            if vi is not None:
                try:
                    bucket = vi.get(value)
                except TypeError:
                    bucket = None
                if bucket is not None:
                    bucket.discard(uid)
                    if not bucket:
                        del vi[value]
                    if not vi:
                        del self._value_index[key]
            uh = self._unhashable.get(key)
            if uh is not None:
                uh.discard(uid)
                if not uh:
                    del self._unhashable[key]

    def rebuild(self, uids: Iterable, metadatas: Iterable[dict]) -> None:
        self.inverted_index = defaultdict(set)
        self._value_index = {}
        self._unhashable = {}
        for uid, md in zip(uids, metadatas):
            self.add(uid, md)

    def load_inverted_index(self, inverted_index, uids, metadatas) -> None:
        """Restore from a pickled inverted_index, rebuilding the value layer."""
        self.rebuild(uids, metadatas)
        # Preserve any extra keys the pickle carried (defensive parity).
        for key, vals in dict(inverted_index).items():
            self.inverted_index[key].update(vals)


class FilterContext:
    """Snapshot of the structures a filter evaluation needs."""

    __slots__ = ("index", "inverse_id_map", "metadata_of_row", "columns")

    def __init__(self, index: MetadataIndex, inverse_id_map: dict,
                 metadata_rows: list, columns: ColumnStore | None = None):
        self.index = index
        self.inverse_id_map = inverse_id_map
        self.metadata_of_row = metadata_rows
        self.columns = columns


def _rows_with_key(ctx: FilterContext, key) -> Iterable[tuple[int, dict]]:
    """(row, metadata) for every live uid in key's posting list."""
    inv = ctx.inverse_id_map
    for uid in ctx.index.inverted_index.get(key, ()):  # uids that HAVE the key
        row = inv.get(uid)
        if row is None:
            continue
        yield row, ctx.metadata_of_row[row]


def _equality_rows(ctx: FilterContext, key, value) -> set[int]:
    """Rows whose metadata[key] == value, via the value index when possible."""
    vi = ctx.index._value_index.get(key)
    uh = ctx.index._unhashable.get(key)
    try:
        hashable = True
        bucket = vi.get(value, set()) if vi is not None else set()
    except TypeError:
        hashable = False
        bucket = set()
    inv = ctx.inverse_id_map
    rows = {inv[uid] for uid in bucket if uid in inv}
    # Unhashable stored values (lists etc.) or unhashable filter values must
    # be compared by scanning the relevant posting subset.
    scan_uids: Iterable = ()
    if not hashable:
        scan_uids = ctx.index.inverted_index.get(key, ())
    elif uh:
        scan_uids = uh
    for uid in scan_uids:
        row = inv.get(uid)
        if row is not None and ctx.metadata_of_row[row].get(key, None) == value:
            rows.add(row)
    return rows


def _match_condition(ctx: FilterContext, key, value):
    """Rows matching one key/value condition (operator dict or equality).

    Returns either a ``set`` of rows or a row-aligned numpy bool mask (the
    vectorized operator path); callers combine via the set/mask helpers."""
    if isinstance(value, dict) and value:
        if ctx.columns is not None:
            mask = ctx.columns.op_mask(key, value)
            if mask is not None:
                return mask
        ops = [( _op_func(op), opv) for op, opv in value.items()]
        out = set()
        for row, md in _rows_with_key(ctx, key):
            mv = md.get(key, None)
            try:
                matched = all(fn(mv, opv) for fn, opv in ops)
            except TypeError:
                # cross-type comparison (e.g. $lt 'red' against a bool):
                # the row simply doesn't match. The columnar fast path
                # already behaves this way (a value outside the column's
                # kind matches nothing); letting the Python fallback RAISE
                # instead would make a search crash or not depending on
                # which rows happen to hold incomparable values — a
                # deliberate robustness deviation from the reference, whose
                # scan catches only KeyError and propagates TypeError
                # (reference vector_database.py:202-203).
                matched = False
            if matched:
                out.add(row)
        return out
    return _equality_rows(ctx, key, value)


def _apply_and(ctx: FilterContext, and_filters: list[dict], filtered):
    for f in and_filters:
        for key, value in f.items():
            rows = _match_condition(ctx, key, value)
            filtered = rows if filtered is None else _and_combine(filtered, rows)
            if _is_empty(filtered):
                return filtered
    return filtered


def _apply_or(ctx: FilterContext, or_filters: list[dict]):
    result = set()
    for f in or_filters:
        for key, value in f.items():
            result = _or_combine(result, _match_condition(ctx, key, value))
    return result


def _apply_exclude(ctx: FilterContext, excludes: list[dict], filtered):
    # Equality-only, like the reference (vector_database.py:320-352): an
    # operator dict here is compared literally and thus never matches.
    for f in excludes:
        for key, value in f.items():
            filtered = _sub_set(filtered, _equality_rows(ctx, key, value))
            if _is_empty(filtered):
                return filtered
    return filtered


class RowSelection:
    """Lazy candidate-row collection.

    ``rows`` is one of: ``None`` = "all live rows" without materializing a
    set (the reference builds ``set(inverse_id_map.values())`` per query even
    with no filter, vector_database.py:356 — an O(N) Python cost the device
    scan should never pay); a ``set`` of row indices; or a row-aligned numpy
    bool mask from the vectorized operator path. ``excluded`` holds
    exclude-filter hits and is non-empty only when ``rows is None`` (a
    concrete selection subtracts eagerly).
    """

    __slots__ = ("rows", "excluded")

    def __init__(self, rows, excluded: set[int] | None = None):
        self.rows = rows
        self.excluded = excluded or set()

    def n_candidates(self, total: int) -> int:
        if self.rows is None:
            return total - len(self.excluded)
        if isinstance(self.rows, np.ndarray):
            return int(self.rows.sum())
        return len(self.rows)

    def to_mask(self, total: int) -> "np.ndarray | None":
        """Boolean row mask (True = candidate), or None for "all rows"."""
        if self.rows is None:
            if not self.excluded:
                return None
            mask = np.ones(total, dtype=bool)
            mask[np.fromiter(self.excluded, dtype=np.int64, count=len(self.excluded))] = False
            return mask
        if isinstance(self.rows, np.ndarray):
            m = self.rows
            if m.shape[0] == total:
                return m
            out = np.zeros(total, dtype=bool)  # defensive: count drift
            out[: min(total, m.shape[0])] = m[: min(total, m.shape[0])]
            return out
        mask = np.zeros(total, dtype=bool)
        if self.rows:
            mask[np.fromiter(self.rows, dtype=np.int64, count=len(self.rows))] = True
        return mask

    def to_set(self) -> set[int]:
        """Materialized row set (only for concrete selections)."""
        if isinstance(self.rows, np.ndarray):
            return set(np.nonzero(self.rows)[0].tolist())
        return self.rows


def select_rows(
    ctx: FilterContext,
    metadata_filter=None,
    exclude_filter=None,
    or_filters=None,
) -> RowSelection:
    """Compute the candidate rows without materializing "all rows".

    Mirrors reference ``_get_filtered_indices`` (vector_database.py:354-386)
    semantics: AND -> OR(∩) -> EXCLUDE(−); no clauses at all selects every
    live row (returned as the lazy all-rows sentinel)."""
    filtered = None

    # An empty dict is falsy = "no filter" (reference vector_database.py:354-356);
    # wrap to a list only AFTER the truthiness check.
    if isinstance(metadata_filter, dict):
        metadata_filter = [metadata_filter] if metadata_filter else None
    if metadata_filter:
        filtered = _apply_and(ctx, metadata_filter, filtered)
        # A truthy metadata_filter with no conditions (e.g. [{}]) selects
        # nothing, matching the pre-lazy behavior (None here means "no
        # condition ever ran", which only the no-filter path may treat as all).
        if filtered is None or _is_empty(filtered):
            return RowSelection(set())

    if or_filters:
        if isinstance(or_filters, dict):
            or_filters = [or_filters]
        or_filters = [f for f in or_filters if f]
        if or_filters:
            ored = _apply_or(ctx, or_filters)
            filtered = ored if filtered is None else _and_combine(filtered, ored)
            if _is_empty(filtered):
                return RowSelection(set())

    if exclude_filter:
        if isinstance(exclude_filter, dict):
            exclude_filter = [exclude_filter]
        if filtered is None:
            excluded: set[int] = set()
            for f in exclude_filter:
                for key, value in f.items():
                    excluded |= _equality_rows(ctx, key, value)
            return RowSelection(None, excluded)
        filtered = _apply_exclude(ctx, exclude_filter, filtered)

    return RowSelection(filtered)


_CACHEABLE_SCALARS = (str, int, float, bool, bytes, type(None))


def _cache_key_part(value):
    """Canonical hashable key for a filter value, or raise TypeError when the
    value's type makes repr-identity unsafe (arbitrary user objects)."""
    import datetime

    if isinstance(value, _CACHEABLE_SCALARS) or isinstance(
        value, (datetime.datetime, datetime.date)
    ):
        return (type(value).__name__, value)
    if isinstance(value, dict):
        return ("d",) + tuple(
            (k, _cache_key_part(v)) for k, v in sorted(value.items(), key=repr)
        )
    if isinstance(value, (list, tuple)):
        return ("l",) + tuple(_cache_key_part(v) for v in value)
    raise TypeError(f"uncacheable filter value type: {type(value)}")


def filters_cache_key(metadata_filter, exclude_filter, or_filters):
    """Hashable key for a (metadata, exclude, or) filter triple, or None when
    any value is of a type whose equality can't be keyed safely."""
    try:
        return (
            _cache_key_part(metadata_filter),
            _cache_key_part(exclude_filter),
            _cache_key_part(or_filters),
        )
    except TypeError:
        return None


def get_filtered_rows(
    ctx: FilterContext,
    metadata_filter=None,
    exclude_filter=None,
    or_filters=None,
) -> set[int]:
    """Materialized candidate row set (compatibility shim over
    ``select_rows``; prefer the lazy form on hot paths)."""
    sel = select_rows(ctx, metadata_filter, exclude_filter, or_filters)
    if sel.rows is None:
        all_rows = set(ctx.inverse_id_map.values())
        return all_rows - sel.excluded if sel.excluded else all_rows
    return sel.to_set()
