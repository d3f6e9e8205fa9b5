"""Data sets over a preprocessed CT-RATE npz tree (counterpart of
vit_exp_tpu/data/datasets.py; numpy items, batched by data/loader.py).

- ``CTReportDataset``: image-report pairs; walks the npz tree, joins the
  reports CSV (Findings_EN and Impressions_EN, keyed by VolumeName), caches
  the file list as text, keeps the first 80% and strips quote and
  parenthesis characters from the reports.
- ``CTReportInferenceDataset``: the zero-shot eval items (volume, text,
  one-hot labels, accession), joined to the labels CSV.
- ``CTSegDataset``: closed-set segmentation pairs from an image and a mask
  folder of pre-cropped npz (no runtime crop), their sorted lists cached
  as text; the image and mask counts must match.
- ``CTOpenSegDataset``: the same pairs through the runtime crop/pad, with
  one prompt per class of a label-name table (``load_label_names``: CSV,
  or the first sheet of an xlsx), tokenized once.

The card's host has no pandas, so the CSVs are read with the stdlib ``csv``
module, with the values pandas' ``read_csv`` would give: a cell that pandas
reads as missing (empty, or one of its default NA strings) is NaN, so an
empty report cell joins as the text "nan" (an empty Findings_EN before
"imp a" gives "nanimp a", and "Not given." before an empty Impressions_EN
gives "Not given.nan", which the "Not given." blank-out does not catch), and
an empty label cell is NaN in float32.  VolumeName keeps its last path
component.  The xlsx label table is read with ``zipfile`` and
``xml.etree`` (the JAX package reads it with pandas and openpyxl).
"""

from __future__ import annotations

import csv
import glob
import math
import os
import re
import zipfile
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

import numpy as np

from vit_exp_tpu_torch.data.preprocess_host import (load_npz_volume,
                                                    runtime_mask,
                                                    runtime_volume)

_STRIP_CHARS = str.maketrans("", "", "\"'()")

# the strings pandas.read_csv reads as NaN by default
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_csv_rows(path: str) -> Tuple[List[str], List[Dict[str, object]]]:
    """(columns, rows) of a CSV with a header line; each row maps a column
    to its string, or to NaN where pandas would read a missing value (a
    short row's absent cells included).  Blank lines are skipped."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        columns = next(reader)
        rows = []
        for cells in reader:
            if not cells:
                continue
            cells = cells + [""] * (len(columns) - len(cells))
            rows.append({c: (math.nan if v in _NA_STRINGS else v)
                         for c, v in zip(columns, cells)})
    return columns, rows


def _accession(value) -> str:
    return str(value).split("/")[-1]


def load_reports(csv_file: str) -> Dict[str, str]:
    """accession → Findings_EN + Impressions_EN, each as pandas would give
    its str() (a missing cell is "nan"; a missing column is left out);
    "Not given." alone becomes ""."""
    _, rows = read_csv_rows(csv_file)
    out = {}
    for row in rows:
        parts = [row.get("Findings_EN"), row.get("Impressions_EN")]
        text = "".join(str(p) for p in parts if p is not None)
        out[_accession(row["VolumeName"])] = "" if text == "Not given." else text
    return out


def load_labels(labels_file: str) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """(label columns, accession → float32 one-hot row); a missing cell is
    NaN."""
    columns, rows = read_csv_rows(labels_file)
    labels = [c for c in columns if c != "VolumeName"]
    return labels, {
        _accession(row["VolumeName"]): np.asarray(
            [float(row[c]) for c in labels], dtype=np.float32)
        for row in rows}


def _cached_list(cache_path: str, build) -> List[str]:
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            return [line.strip() for line in f if line.strip()]
    items = build()
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    with open(cache_path, "w") as f:
        f.writelines(f"{item}\n" for item in items)
    return items


def _walk_npz(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".npz"):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def _npz_accession(path: str) -> str:
    return os.path.basename(path).replace(".npz", ".nii.gz")


class CTReportDataset:
    """Image-report pairs for the contrastive path."""

    _load_reports = staticmethod(load_reports)

    def __init__(self, data_folder: str, csv_file: str, *, tokenizer=None,
                 keep_percent: int = 80, max_text_len: int = 512,
                 cache_dir: Optional[str] = None):
        self.data_folder = data_folder
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        acc_to_text = load_reports(csv_file)
        cache_dir = cache_dir or os.path.join(data_folder,
                                              "tmp_cache_data_list")
        files = _cached_list(os.path.join(cache_dir, "image_samples_tpu.txt"),
                             lambda: _walk_npz(data_folder))
        self.samples: List[Tuple[str, str]] = [
            (path, acc_to_text[_npz_accession(path)]) for path in files
            if _npz_accession(path) in acc_to_text]
        # the reference keeps the first 80% as its train split
        self.samples = self.samples[: len(self.samples) * keep_percent // 100]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        path, text = self.samples[index]
        volume = runtime_volume(load_npz_volume(path))
        text = text.translate(_STRIP_CHARS)
        item = {"image": volume, "text": text, "data_type": "imagereport"}
        if self.tokenizer is not None:
            toks = self.tokenizer([text], max_length=self.max_text_len)
            item["input_ids"] = toks["input_ids"][0]
            item["attention_mask"] = toks["attention_mask"][0]
        return item


class CTReportInferenceDataset:
    """Zero-shot eval samples: (volume, text, one-hot labels, accession) of
    every npz whose accession both CSVs name."""

    def __init__(self, data_folder: str, csv_file: str, labels_file: str, *,
                 tokenizer=None, max_text_len: int = 512,
                 limit: Optional[int] = None):
        acc_to_text = load_reports(csv_file)
        self.label_columns, acc_to_onehot = load_labels(labels_file)
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.samples = []
        for path in _walk_npz(data_folder):
            accession = _npz_accession(path)
            if accession in acc_to_text and accession in acc_to_onehot:
                self.samples.append((path, acc_to_text[accession],
                                     acc_to_onehot[accession], accession))
        if limit:
            self.samples = self.samples[:limit]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        path, text, onehot, accession = self.samples[index]
        return {"image": runtime_volume(load_npz_volume(path)), "text": text,
                "onehot": onehot, "accession": accession}


class CTSegDataset:
    """Closed-set segmentation pairs (pre-cropped npz, no runtime crop)."""

    def __init__(self, data_folder: str, mask_folder: str):
        images = _cached_list(
            os.path.join(data_folder, "tmp_cache_data_list",
                         "image_samples_tpu.txt"),
            lambda: sorted(glob.glob(os.path.join(data_folder, "*.npz"))))
        masks = _cached_list(
            os.path.join(mask_folder, "tmp_cache_mask_list",
                         "mask_samples_tpu.txt"),
            lambda: sorted(glob.glob(os.path.join(mask_folder, "*.npz"))))
        # zip would truncate silently and pair every image after a gap
        # with the wrong mask (JAX's assert, raised under -O too)
        if len(images) != len(masks):
            raise AssertionError(
                f"{len(images)} images vs {len(masks)} masks — the sorted "
                "lists would misalign")
        self.samples = list(zip(images, masks))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        img_path, mask_path = self.samples[index]
        return {"image": load_npz_volume(img_path)[None].astype(np.float32),
                "seg_mask": load_npz_volume(mask_path).astype(np.float32),
                "data_type": "imageseg"}


_XLSX = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
         "r": "http://schemas.openxmlformats.org/officeDocument/2006/"
              "relationships",
         "rel": "http://schemas.openxmlformats.org/package/2006/"
                "relationships"}


def _xlsx_text(node) -> str:
    """The text of a shared string or inline string (its runs joined)."""
    return "".join(t.text or "" for t in node.iter(f"{{{_XLSX['m']}}}t"))


def _xlsx_number(text: str):
    """A numeric cell as openpyxl reads it: int unless it has a point or
    an exponent."""
    return float(text) if re.search(r"[.eE]", text) else int(text)


def read_xlsx_rows(path: str) -> Tuple[List[str], List[Dict[str, object]]]:
    """(columns, rows) of the first sheet of an xlsx workbook, its first row
    the header: text cells as str, numbers as int or float, empty cells
    NaN."""
    m = f"{{{_XLSX['m']}}}"
    with zipfile.ZipFile(path) as z:
        book = ElementTree.fromstring(z.read("xl/workbook.xml"))
        rid = book.find(f"{m}sheets/{m}sheet").get(f"{{{_XLSX['r']}}}id")
        rels = ElementTree.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        target = next(r.get("Target") for r in rels
                      if r.get("Id") == rid)
        target = (target.lstrip("/") if target.startswith("/")
                  else "xl/" + target)
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            shared = [_xlsx_text(si) for si in ElementTree.fromstring(
                z.read("xl/sharedStrings.xml")).iter(f"{m}si")]
        sheet = ElementTree.fromstring(z.read(target))
    table = []
    for row in sheet.iter(f"{m}row"):
        cells = {}
        for c in row.iter(f"{m}c"):
            col = re.match(r"[A-Z]+", c.get("r")).group()
            kind, v = c.get("t"), c.find(f"{m}v")
            if kind == "inlineStr":
                cells[col] = _xlsx_text(c.find(f"{m}is"))
            elif v is None or v.text is None:
                continue
            elif kind == "s":
                cells[col] = shared[int(v.text)]
            elif kind in ("str", "e"):
                cells[col] = v.text
            elif kind == "b":
                cells[col] = v.text == "1"
            else:
                cells[col] = _xlsx_number(v.text)
        table.append(cells)
    header = table[0]
    letters = sorted(header, key=lambda a: (len(a), a))
    columns = [str(header[a]) for a in letters]
    rows = [{name: r.get(a, math.nan) for a, name in zip(letters, columns)}
            for r in table[1:] if r]
    return columns, rows


def _int(value) -> int:
    return int(float(value)) if isinstance(value, str) and re.search(
        r"[.eE]", value) else int(value)


def load_label_names(table_path: str) -> Dict[int, str]:
    """ID → NAME of a label table: CSV (read as ``read_csv_rows`` reads it)
    or the first sheet of an xlsx workbook."""
    if table_path.endswith(".csv"):
        _, rows = read_csv_rows(table_path)
    else:
        _, rows = read_xlsx_rows(table_path)
    return {_int(row["ID"]): str(row["NAME"]) for row in rows}


PROMPT_TEMPLATES = {
    "this_region": "This is region of {name}.",
    "this_is": "This is {name}.",
}


class CTOpenSegDataset:
    """Open-vocabulary segmentation with pre-tokenized class prompts: one
    per ID of the label table, in ID order."""

    def __init__(self, data_folder: str, mask_folder: str,
                 seg_mask_name_table: str, *, tokenizer,
                 seg_mask_prompt_type: str = "this_region",
                 max_text_len: int = 512):
        template = PROMPT_TEMPLATES[seg_mask_prompt_type]
        names = load_label_names(seg_mask_name_table)
        self.class_ids = sorted(names)
        toks = tokenizer([template.format(name=names[i])
                          for i in self.class_ids], max_length=max_text_len)
        self.prompt_ids = toks["input_ids"]          # (C, L)
        self.prompt_mask = toks["attention_mask"]    # (C, L)
        self._pairs = CTSegDataset(data_folder, mask_folder).samples

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, index: int) -> Dict:
        img_path, mask_path = self._pairs[index]
        return {"image": runtime_volume(load_npz_volume(img_path)),
                "seg_mask": runtime_mask(load_npz_volume(mask_path)),
                "prompt_ids": self.prompt_ids,
                "prompt_mask": self.prompt_mask,
                "data_type": "imageopenseg"}
