"""Data sets over a preprocessed CT-RATE npz tree (counterpart of
vit_exp_tpu/data/datasets.py; numpy items, batched by data/loader.py).

- ``CTReportDataset``: image-report pairs; walks the npz tree, joins the
  reports CSV (Findings_EN and Impressions_EN, keyed by VolumeName), caches
  the file list as text, keeps the first 80% and strips quote and
  parenthesis characters from the reports.
- ``CTReportInferenceDataset``: the zero-shot eval items (volume, text,
  one-hot labels, accession), joined to the labels CSV.

The card's host has no pandas, so the CSVs are read with the stdlib ``csv``
module, with the values pandas' ``read_csv`` would give: a cell that pandas
reads as missing (empty, or one of its default NA strings) is NaN, so an
empty report cell joins as the text "nan" (an empty Findings_EN before
"imp a" gives "nanimp a", and "Not given." before an empty Impressions_EN
gives "Not given.nan", which the "Not given." blank-out does not catch), and
an empty label cell is NaN in float32.  VolumeName keeps its last path
component.  The segmentation data sets come with the mask tools.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from vit_exp_tpu_torch.data.preprocess_host import (load_npz_volume,
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
