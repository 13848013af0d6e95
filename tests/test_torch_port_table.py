"""Port parity: ``spaa_tpu_torch.utils.table`` and ``utils/xlsx.py`` against
pandas (3.x, the version ``spaa_tpu`` runs with here) and against
``spaa_tpu.utils.xlsx``: the CSV text, ``read_csv``'s column types, the
pivot with its sort, and the ``.xlsx`` sheet part, for stats-shaped
tables, mixed ``'-'`` rows and a pivot."""

import zipfile

import numpy as np
import pandas as pd
import pytest

from spaa_tpu.utils import xlsx as JX
from spaa_tpu_torch.attack.summarize import (COLUMNS, PIVOT_INDEX,
                                             PIVOT_VALUES)
from spaa_tpu_torch.utils import table as T
from spaa_tpu_torch.utils import xlsx as TX


def _stats_rows(rng, setups=("s1", "s2"), d_thrs=(5, 7, 11), dash=False):
    """Rows shaped like summarize's: key strings, int d_thr (or '-'),
    success-rate floats, untargeted ints, 6 validation + 54 metrics."""
    rows = []
    for s in setups:
        for loss in ("caml2", "camdE"):
            for d in d_thrs:
                for clf in ("vgg16", "resnet18"):
                    rates = list(rng.integers(0, 11, 4) / 10)
                    rows.append([s, "SPAA_PCNet_l1+ssim_500_24_2000", loss, d,
                                 clf, *rates, int(rng.integers(0, 2)),
                                 int(rng.integers(0, 2))]
                                + list(rng.random(6) * 30)
                                + list(rng.random(54) * 40))
    if dash:
        rows.append(["s1", "One-pixel_DE", "-", "-", "resnet18", 0.1, 0.2,
                     0.3, 0.4, 1, 0, *([0] * 6), *([float("inf")] * 2),
                     *(rng.random(52) * 40)])
    return rows


def _both(rows, columns=COLUMNS):
    df = pd.DataFrame(columns=columns)
    tab = T.Table(columns)
    for r in rows:
        df.loc[len(df)] = r
        tab.append(r)
    return df, tab


@pytest.mark.parametrize("dash", [False, True])
def test_to_csv_equals_pandas(dash):
    df, tab = _both(_stats_rows(np.random.default_rng(0), dash=dash))
    want = df.to_csv(index=False, float_format="%.4f", sep="\t")
    assert tab.to_csv(sep="\t", float_format="%.4f") == want
    assert tab.to_csv() == df.to_csv(index=False)
    # an empty table writes its header only
    assert T.Table(COLUMNS).to_csv(sep="\t", float_format="%.4f") == \
        pd.DataFrame(columns=COLUMNS).to_csv(index=False, sep="\t",
                                             float_format="%.4f")


def test_kind_inference_and_missing_values_match_pandas():
    cols = ["a", "b", "c", "d", "e", "f"]
    rows = [["x", 1, 2, 0.5, True, None], [None, 2, 2.5, 1, False, 3],
            ["z", 3, 1, float("nan"), True, "w"]]
    df, tab = _both(rows, cols)
    assert tab.to_csv(float_format="%.3f") == df.to_csv(index=False,
                                                        float_format="%.3f")


@pytest.mark.parametrize("dash", [False, True])
def test_read_csv_types_and_concat_match_pandas(tmp_path, dash):
    rng = np.random.default_rng(1)
    paths = []
    for k, d_thrs in enumerate(((5, 7), (9, 11))):
        df, _ = _both(_stats_rows(rng, setups=(f"s{k}",), d_thrs=d_thrs,
                                  dash=dash and k == 1))
        p = tmp_path / f"stats{k}.txt"
        df.to_csv(p, index=False, float_format="%.4f", sep="\t")
        paths.append(str(p))
    pd_tabs = [pd.read_csv(p, sep="\t") for p in paths]
    t_tabs = [T.read_csv(p, sep="\t") for p in paths]
    for want, got in zip(pd_tabs, t_tabs):
        assert want.values.tolist() == got.typed_rows()
        assert [str(c) for c in want.columns] == got.columns
    d_col = COLUMNS.index("d_thr")
    # an all-integer d_thr stays numeric; with '-' it is text
    assert t_tabs[0].kinds[d_col] == "int"
    assert t_tabs[1].kinds[d_col] == ("str" if dash else "int")
    want = pd.concat(pd_tabs, axis=0, ignore_index=True)
    got = T.concat(t_tabs)
    assert got.to_csv(sep="\t", float_format="%.4f") == \
        want.to_csv(index=False, float_format="%.4f", sep="\t")
    assert [str(v) for v in want["d_thr"]] == [str(v) for v in got["d_thr"]]


def test_concat_with_empty_table_matches_pandas(tmp_path):
    df, _ = _both(_stats_rows(np.random.default_rng(2), setups=("s1",)))
    full, empty = tmp_path / "full.txt", tmp_path / "empty.txt"
    df.to_csv(full, index=False, float_format="%.4f", sep="\t")
    pd.DataFrame(columns=COLUMNS).to_csv(empty, index=False, sep="\t")
    want = pd.concat([pd.read_csv(empty, sep="\t"),
                      pd.read_csv(full, sep="\t")], ignore_index=True)
    got = T.concat([T.read_csv(str(empty), "\t"), T.read_csv(str(full), "\t")])
    assert got.to_csv(sep="\t", float_format="%.4f") == \
        want.to_csv(index=False, float_format="%.4f", sep="\t")


def _pivot_pair(tmp_path, rows):
    df, _ = _both(rows)
    p = tmp_path / "stats_all.txt"
    df.to_csv(p, index=False, float_format="%.4f", sep="\t")
    pdf = pd.read_csv(p, sep="\t")
    want = pd.pivot_table(pdf, values=PIVOT_VALUES, index=PIVOT_INDEX,
                          aggfunc="mean", sort=False)
    want = want.sort_index(level=[0, 1], ascending=[False, True])
    got = T.read_csv(str(p), "\t").pivot_table(PIVOT_VALUES, PIVOT_INDEX)
    got = got.sort_index(level=[0, 1], ascending=[False, True])
    return want, got


@pytest.mark.parametrize("dash", [False, True])
def test_pivot_and_sort_match_pandas(tmp_path, dash):
    rows = _stats_rows(np.random.default_rng(3), setups=("s1", "s2", "s3"))
    if dash:
        # One-pixel DE's '-' rows as spaa_tpu writes them: d_thr becomes
        # text for the whole table, so "11" sorts before "5"
        rows = [r[:3] + [str(r[3])] + r[4:] for r in rows]
        rows += [["s1", "One-pixel_DE", "-", "-", c, 0.1, 0.2, 0.3, 0.4, 1,
                  0, *([0] * 6), *np.arange(54.0)] for c in ("vgg16",
                                                            "resnet18")]
    want, got = _pivot_pair(tmp_path, rows)
    flat = want.reset_index()
    assert [str(c) for c in flat.columns] == got.columns
    assert got.columns[4:] == PIVOT_VALUES
    keys = [tuple(str(v) for v in r[:4]) for r in flat.values.tolist()]
    assert keys == [tuple(str(v) for v in r[:4]) for r in got.typed_rows()]
    np.testing.assert_allclose(
        np.array([r[4:] for r in got.typed_rows()], float),
        flat[PIVOT_VALUES].to_numpy(float), rtol=1e-13, atol=0)
    if dash:
        assert [k[1] for k in keys[:4]] == ["11", "11", "11", "11"]
    # levels 2-3 keep their first-appearance order (no sort_remaining)
    assert [k[2:] for k in keys[:2]] == [("caml2", "vgg16"),
                                         ("caml2", "resnet18")]


def _sheet(path):
    with zipfile.ZipFile(path) as z:
        return z.read("xl/worksheets/sheet1.xml")


def test_xlsx_sheet_equals_spaa_tpu_writer(tmp_path):
    rows = _stats_rows(np.random.default_rng(4), setups=("s1", "s2"))
    df, tab = _both(rows)
    JX.to_excel(df, str(tmp_path / "j.xlsx"), index=False)
    TX.to_excel(tab, str(tmp_path / "t.xlsx"), index=False)
    assert _sheet(tmp_path / "t.xlsx") == _sheet(tmp_path / "j.xlsx")
    # the pivot, its index levels as leading columns
    want, got = _pivot_pair(tmp_path, rows)
    JX.to_excel(want, str(tmp_path / "jp.xlsx"), index=True)
    TX.to_excel(got, str(tmp_path / "tp.xlsx"), index=True)
    assert _sheet(tmp_path / "tp.xlsx") == _sheet(tmp_path / "jp.xlsx")
    assert TX.read_xlsx(str(tmp_path / "tp.xlsx")) == \
        JX.read_xlsx(str(tmp_path / "jp.xlsx"))
    # a table without an index, written with one; an all-numeric table
    num = pd.DataFrame({"x": [1, 2], "y": [0.5, 1.25]})
    tnum = T.Table(["x", "y"], [[1, 0.5], [2, 1.25]])
    for index in (False, True):
        JX.to_excel(num, str(tmp_path / "jn.xlsx"), index=index)
        TX.to_excel(tnum, str(tmp_path / "tn.xlsx"), index=index)
        assert _sheet(tmp_path / "tn.xlsx") == _sheet(tmp_path / "jn.xlsx")
