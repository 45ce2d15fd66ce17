"""Minimal .xlsx writer (stdlib only).

The port's copy of ``cglgan_tpu/utils/xlsx.py``.  The reference exports its
metric table to Excel every eval tick via ``pandas.DataFrame.to_excel``
(FLGAN/2DMG/flgan.py:102-103); XLSX is a zip of XML parts, so a
single-sheet writer needs only the stdlib, not openpyxl.  Numbers are
written as numeric cells, everything else as inline strings.
"""
from __future__ import annotations

import zipfile
from typing import Dict, List, Sequence
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="metrics" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    out = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 26)
        out = chr(65 + r) + out
    return out


def _cell(row: int, col: int, value) -> str:
    ref = f"{_col_name(col)}{row}"
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        import math
        if isinstance(value, float) and not math.isfinite(value):
            # Excel rejects <v>nan</v>/<v>inf</v> numeric cells
            return (f'<c r="{ref}" t="inlineStr"><is><t>{value!r}</t>'
                    '</is></c>')
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    s = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t>{s}</t></is></c>'


def write_xlsx(path: str, records: List[Dict], fields: Sequence[str] = None):
    """Write a list of dicts as one sheet (header row + one row per record)."""
    if fields is None:
        fields = []
        for r in records:
            for k in r:
                if k not in fields:
                    fields.append(k)
    rows_xml = []
    header = "".join(_cell(1, c, k) for c, k in enumerate(fields))
    rows_xml.append(f'<row r="1">{header}</row>')
    for i, rec in enumerate(records, start=2):
        cells = "".join(_cell(i, c, rec.get(k, "")) for c, k in
                        enumerate(fields))
        rows_xml.append(f'<row r="{i}">{cells}</row>')
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>'
             + "".join(rows_xml) + "</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
