"""Minimal one-sheet ``.xlsx`` writer and reader (counterpart of
``spaa_tpu/utils/xlsx.py``).

An ``.xlsx`` is a zip of four small SpreadsheetML parts: inline strings,
numbers as numbers. :func:`to_excel` writes a :class:`~.table.Table` as
``spaa_tpu.utils.xlsx.to_excel`` writes a DataFrame, cell for cell: floats
rounded through ``float_format`` and still stored as numbers, missing
values as empty cells, and with ``index=True`` the index levels as leading
columns under ``reset_index``'s names (``index`` for a table without
one).
"""

from __future__ import annotations

import math
import re
import zipfile
from typing import Optional
from xml.sax.saxutils import escape

from spaa_tpu_torch.utils.table import Table, is_na

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType='
    '"application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
    'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns='
    '"http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    "</Relationships>"
)

_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns='
    '"http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
    'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/'
    'relationships"><sheets>'
    '<sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
)

_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns='
    '"http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/worksheet" '
    'Target="worksheets/sheet1.xml"/></Relationships>'
)


def _col_letter(i: int) -> str:
    """0-based column index -> A1-style letters."""
    s = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 26)
        s = chr(ord("A") + r) + s
    return s


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        if isinstance(value, float) and (math.isnan(value)
                                         or math.isinf(value)):
            # Excel has no numeric NaN/inf cells; write the string form
            return f'<c r="{ref}" t="inlineStr"><is><t>{value}</t></is></c>'
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    return f'<c r="{ref}" t="inlineStr"><is><t>{escape(str(value))}</t></is></c>'


def sheet_xml(rows) -> str:
    """The ``xl/worksheets/sheet1.xml`` part for ``rows``."""
    body = []
    for r, row in enumerate(rows, start=1):
        cells = "".join(_cell_xml(f"{_col_letter(c)}{r}", v)
                        for c, v in enumerate(row))
        body.append(f'<row r="{r}">{cells}</row>')
    return ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns='
            '"http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
            "<sheetData>" + "".join(body) + "</sheetData></worksheet>")


def write_xlsx(path: str, rows) -> None:
    """Write ``rows`` (iterables of str/int/float/bool/None) as a one-sheet
    ``.xlsx``."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet_xml(rows))


def _coerce(value, float_format: Optional[str]):
    if is_na(value):
        return None
    if isinstance(value, float):
        if float_format and math.isfinite(value):
            return float(float_format % value)
        return value
    if isinstance(value, (bool, int)):
        return value
    return str(value)


def _excel_rows(table: Table, index: bool = False,
                float_format: Optional[str] = "%.4f") -> list:
    """Header and cell values as ``spaa_tpu``'s ``to_excel`` writes them."""
    columns, kinds = list(table.columns), list(table.kinds)
    rows = table.typed_rows()
    n_idx = len(table.index_names)
    if index and not n_idx:
        columns, kinds = ["index"] + columns, ["int"] + kinds
        rows = [[i] + r for i, r in enumerate(rows)]
    elif not index and n_idx:
        columns, kinds = columns[n_idx:], kinds[n_idx:]
        rows = [r[n_idx:] for r in rows]
    # DataFrame.iterrows gives an all-numeric frame's rows as float Series
    if set(kinds) <= {"int", "float"} and "float" in kinds:
        rows = [[None if v is None else float(v) for v in r] for r in rows]
    return [[str(c) for c in columns]] + [
        [_coerce(v, float_format) for v in r] for r in rows]


def to_excel(table: Table, path: str, index: bool = False,
             float_format: Optional[str] = "%.4f") -> None:
    """``DataFrame.to_excel`` without a pandas engine (one sheet)."""
    write_xlsx(path, _excel_rows(table, index, float_format))


def read_xlsx(path: str):
    """Rows of a file written by :func:`write_xlsx`, gaps as None."""
    from xml.etree import ElementTree
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        sheet = z.read("xl/worksheets/sheet1.xml").decode()
    root = ElementTree.fromstring(sheet)
    out = []
    for row in root.iter(f"{ns}row"):
        cells = {}
        for c in row.iter(f"{ns}c"):
            ref = c.attrib["r"]
            col = sum((ord(ch) - ord("A") + 1) * 26 ** i
                      for i, ch in enumerate(reversed(
                          re.match(r"[A-Z]+", ref).group(0)))) - 1
            if c.attrib.get("t") == "inlineStr":
                t = c.find(f"{ns}is/{ns}t")
                cells[col] = t.text if t is not None else ""
            elif c.attrib.get("t") == "b":
                cells[col] = bool(int(c.find(f"{ns}v").text))
            else:
                v = c.find(f"{ns}v")
                if v is not None:
                    num = float(v.text)
                    cells[col] = int(num) if num.is_integer() else num
        width = max(cells) + 1 if cells else 0
        out.append([cells.get(i) for i in range(width)])
    return out
