"""A small column table that stands in for what the port asks of pandas.

``spaa_tpu`` builds its training log, per-setup stats tables and the
cross-setup pivot table with pandas; the GPU machine has no pandas. This
table does those few things, and writes and reads them as pandas 3 does:

  - columns have one of five kinds, inferred from their values as pandas
    infers a column's dtype: ``int``, ``float`` (numbers with at least one
    float, or ints with a missing value), ``bool``, ``str`` (text, with
    missing values) and ``object`` (anything else, and every column of a
    table without rows);
  - ``to_csv(sep, float_format)`` prints as ``DataFrame.to_csv(index=False)``
    does: a float column through ``float_format``, an ``object`` column
    value by value through ``str``, a missing value as an empty field,
    quoting by the ``csv`` module;
  - :func:`read_csv` infers each column's kind as pandas' C parser does
    (an all-integer column stays numeric; integers mixed with ``'-'`` make
    a text column, which sorts as text);
  - :func:`concat` joins tables of the same columns, the kinds combined as
    ``pd.concat`` combines dtypes;
  - :meth:`Table.pivot_table` with ``aggfunc="mean", sort=False`` and
    :meth:`Table.sort_index` on some index levels with a list of
    ``ascending`` flags (a stable sort on those levels alone: pandas then
    skips ``sort_remaining``).

A pivot's index levels are its leading columns, named by ``index_names``.
"""

from __future__ import annotations

import csv
import io
import re
from typing import Optional, Sequence

import numpy as np

_NA_STRINGS = {"", "-1.#IND", "1.#QNAN", "1.#IND", "-1.#QNAN", "#N/A N/A",
               "#N/A", "N/A", "n/a", "NA", "<NA>", "#NA", "NULL", "null",
               "NaN", "-NaN", "nan", "-nan", "None"}
_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$"
                    r"|^[-+]?(inf|infinity)$", re.IGNORECASE)
_NUMERIC = ("int", "float")


def is_na(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _kind_of(v) -> str:
    if is_na(v):
        return "na"
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, str):
        return "str"
    return "object"


def infer_kind(values) -> str:
    """The kind pandas gives a column holding ``values``."""
    kinds = {_kind_of(v) for v in values}
    if not kinds:
        return "object"
    has_na = "na" in kinds
    kinds.discard("na")
    if not kinds:
        return "float"
    if kinds <= set(_NUMERIC):
        return "int" if kinds == {"int"} and not has_na else "float"
    if kinds == {"bool"} and not has_na:
        return "bool"
    if kinds == {"str"}:
        return "str"
    return "object"


def _cast(v, kind: str):
    """A value as its column's kind holds it."""
    if is_na(v):
        return None
    if kind == "float":
        return float(v)
    if kind == "int":
        return int(v)
    if kind == "bool":
        return bool(v)
    if isinstance(v, np.generic):
        return v.item()
    return v


class Table:
    """Rows of values under named columns."""

    def __init__(self, columns: Sequence[str], rows=None,
                 index_names: Sequence[str] = (), kinds=None):
        self.columns = list(columns)
        self.index_names = list(index_names)
        self.rows: list = []
        for r in rows or []:
            self.append(r)
        # kinds given by concat / pivot / read_csv, as pandas keeps a
        # frame's dtypes; an append infers them again
        self._kinds = None if kinds is None else list(kinds)

    def __len__(self) -> int:
        return len(self.rows)

    def append(self, row) -> None:
        """Add one row (``df.loc[len(df)] = row``); kinds are inferred
        again from all values."""
        if len(row) != len(self.columns):
            raise ValueError(f"a row has {len(self.columns)} values, got "
                             f"{len(row)}")
        self.rows.append(list(row))
        self._kinds = None

    def __getitem__(self, name: str) -> list:
        """The column ``name``, each value cast to the column's kind."""
        j = self.columns.index(name)
        kind = self.kinds[j]
        return [_cast(r[j], kind) for r in self.rows]

    @property
    def kinds(self) -> list:
        if self._kinds is None:
            self._kinds = [infer_kind([r[j] for r in self.rows])
                           for j in range(len(self.columns))]
        return self._kinds

    def typed_rows(self) -> list:
        """Rows with every value cast to its column's kind."""
        kinds = self.kinds
        return [[_cast(v, k) for v, k in zip(r, kinds)] for r in self.rows]

    def head(self, n: int = 5) -> "Table":
        return Table(self.columns, self.rows[:n], self.index_names,
                     self.kinds)

    # ------------------------------------------------------------ output
    def _cells(self, float_format: Optional[str]) -> list:
        def cell(v, kind):
            if is_na(v):
                return ""
            if kind == "float":
                return (float_format % float(v) if float_format
                        else repr(float(v)))
            if kind == "int":
                return str(int(v))
            if isinstance(v, np.generic):
                v = v.item()
            return str(v)

        kinds = self.kinds
        return [[cell(v, k) for v, k in zip(r, kinds)] for r in self.rows]

    def to_csv(self, path: Optional[str] = None, sep: str = ",",
               float_format: Optional[str] = None):
        """``DataFrame.to_csv(path, sep=sep, float_format=float_format,
        index=False)``; returns the text when ``path`` is None."""
        buf = io.StringIO()
        w = csv.writer(buf, delimiter=sep, lineterminator="\n")
        w.writerow(self.columns)
        w.writerows(self._cells(float_format))
        text = buf.getvalue()
        if path is None:
            return text
        with open(path, "w") as f:
            f.write(text)
        return None

    def to_string(self) -> str:
        """Right-aligned columns, floats ``%.4f``, for the console."""
        rows = [self.columns] + self._cells("%.4f")
        widths = [max(len(r[c]) for r in rows)
                  for c in range(len(self.columns))]
        return "\n".join("  ".join(v.rjust(wd) for v, wd in zip(r, widths))
                         for r in rows)

    def __str__(self) -> str:
        return self.to_string()

    # ------------------------------------------------------------- pivot
    def pivot_table(self, values: Sequence[str], index: Sequence[str]
                    ) -> "Table":
        """``pd.pivot_table(self, values, index, aggfunc="mean",
        sort=False)``: one row per distinct index tuple in order of first
        appearance (tuples holding a missing value dropped, as groupby
        does), the mean of each value column over its non-missing values
        (Kahan-summed, as pandas' group mean), rows whose every mean is
        missing dropped; the value columns in the order given."""
        ki = [self.columns.index(c) for c in index]
        kv = [self.columns.index(c) for c in values]
        kinds = self.kinds
        groups: dict = {}
        for r in self.typed_rows():
            key = tuple(r[j] for j in ki)
            if any(is_na(k) for k in key):
                continue
            groups.setdefault(key, []).append(r)
        out = []
        for key, rows in groups.items():
            means = []
            for j in kv:
                vals = [r[j] for r in rows if not is_na(r[j])]
                if any(isinstance(v, (str, bool)) for v in vals):
                    raise TypeError(f"cannot average column "
                                    f"{self.columns[j]!r}")
                s = comp = 0.0
                for v in vals:
                    y = float(v) - comp
                    t = s + y
                    comp = (t - s) - y
                    s = t
                means.append(s / len(vals) if vals else None)
            if all(m is None for m in means):
                continue
            out.append(list(key) + means)
        return Table(list(index) + list(values), out, index_names=index,
                     kinds=[kinds[j] for j in ki] + ["float"] * len(kv))

    def sort_index(self, level: Sequence[int], ascending: Sequence[bool]
                   ) -> "Table":
        """``sort_index(level=level, ascending=ascending)`` with a list of
        flags: a stable sort on the named index levels only (pandas skips
        ``sort_remaining`` when ``ascending`` is a list), each level by
        value, or by first appearance where its values do not compare
        (pandas leaves such a level unsorted)."""
        if len(level) != len(ascending):
            raise ValueError("level must have same length as ascending")
        kinds = self.kinds
        ranks = []
        for lv in level:
            vals = [_cast(r[lv], kinds[lv]) for r in self.rows]
            uniq = list(dict.fromkeys(vals))
            try:
                uniq = sorted(uniq)
            except TypeError:
                pass
            pos = {v: i for i, v in enumerate(uniq)}
            ranks.append([pos[v] for v in vals])
        order = sorted(range(len(self.rows)), key=lambda i: tuple(
            rk[i] if up else -rk[i] for rk, up in zip(ranks, ascending)))
        return Table(self.columns, [self.rows[i] for i in order],
                     self.index_names, kinds)


def concat(tables: Sequence[Table]) -> Table:
    """``pd.concat(tables, axis=0, ignore_index=True)`` of tables with the
    same columns: each column's kinds combined (equal kinds stay, int and
    float give float, anything else object, so a table without rows makes
    its columns object)."""
    if not tables:
        raise ValueError("no tables to concatenate")
    cols = tables[0].columns
    for t in tables[1:]:
        if t.columns != cols:
            raise ValueError("tables to concatenate have other columns")
    kinds = []
    for j in range(len(cols)):
        ks = {t.kinds[j] for t in tables}
        if len(ks) == 1:
            kinds.append(ks.pop())
        elif ks <= set(_NUMERIC):
            kinds.append("float")
        else:
            kinds.append("object")
    rows = [[_cast(v, tk) if tk != "object" else v
             for v, tk in zip(r, t.kinds)]
            for t in tables for r in t.rows]
    return Table(cols, rows, tables[0].index_names, kinds)


def _parse_field(text: str):
    if text in _NA_STRINGS:
        return None, "na"
    if _INT.match(text):
        return int(text), "int"
    if _FLOAT.match(text):
        return float(text), "float"
    if text in ("True", "TRUE", "true"):
        return True, "bool"
    if text in ("False", "FALSE", "false"):
        return False, "bool"
    return text, "str"


def read_csv(path: str, sep: str = ",") -> Table:
    """``pd.read_csv(path, sep=sep)`` for a file with a header row: each
    column's kind inferred from all its fields (int, then float, then bool,
    else text with the original strings). ``sep=r"\\s+"`` splits on runs
    of whitespace, skipping blank lines, as pandas does."""
    with open(path, newline="") as f:
        if sep == r"\s+":
            records = [line.split() for line in f if line.strip()]
        else:
            records = list(csv.reader(f, delimiter=sep))
    if not records:
        raise ValueError(f"{path} is empty")
    cols, body = records[0], records[1:]
    out = [[None] * len(cols) for _ in body]
    kinds = []
    for j in range(len(cols)):
        fields = [r[j] if j < len(r) else "" for r in body]
        parsed = [_parse_field(s) for s in fields]
        ks = {k for _, k in parsed}
        if not body:
            kind = "object"
        elif ks <= {"int", "float", "na"} and ks != {"na"}:
            kind = "int" if ks == {"int"} else "float"
        elif ks == {"na"}:
            kind = "float"
        elif ks == {"bool"}:
            kind = "bool"
        else:
            kind = "str"
        for i, (s, (v, k)) in enumerate(zip(fields, parsed)):
            out[i][j] = (None if k == "na" else s) if kind == "str" else v
        kinds.append(kind)
    return Table(cols, out, kinds=kinds)
