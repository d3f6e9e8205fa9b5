"""CPU parity of the port's real-format ingest against the JAX package:
the NIfTI reader, the preprocessing chain, the packed store (both
directions, the native reader and its numpy fallback), the CT-RATE data
sets over a CSV with pandas' quirks, ``pack_dataset`` and
``preprocess_ctrate``.

Tolerances: exact for the reader, ``hu_normalize``, the crop/pad, the
runtime stage and its numpy twins, the packed bytes and the data set items;
relative L2 1e-6 for ``resize_trilinear`` and the offline stage (fp32 lerps
that XLA may contract into other roundings).

The runtime crop/pad targets (480, 480, 240) in both packages; the tests
that go through the data sets crop to a small target instead, by the same
``runtime_volume`` substitution in both.
"""

import functools
import json
import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_data_tools import _write_nifti
from vit_exp_tpu.cli import pack_dataset as jpack
from vit_exp_tpu.cli import preprocess_ctrate as jprep
from vit_exp_tpu.data import datasets as jdatasets
from vit_exp_tpu.data import nifti as jnifti
from vit_exp_tpu.data import packed as jpacked
from vit_exp_tpu.data import preprocess_host as jhost
from vit_exp_tpu.ops import preprocess as jpp
from vit_exp_tpu_torch import native
from vit_exp_tpu_torch.cli import pack_dataset as tpack
from vit_exp_tpu_torch.cli import preprocess_ctrate as tprep
from vit_exp_tpu_torch.data import datasets as tdatasets
from vit_exp_tpu_torch.data import nifti as tnifti
from vit_exp_tpu_torch.data import packed as tpacked
from vit_exp_tpu_torch.data import preprocess_host as thost
from vit_exp_tpu_torch.ops import preprocess as tpp

SMALL_HWD = (12, 10, 6)   # a runtime target the test volumes both exceed
                          # and fall short of


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- NIfTI ------------------------------------------------------------------


def _write_nifti_be(path, data, pixdim):
    """A big-endian float32 NIfTI-1 file with a slope and an intercept."""
    hdr = bytearray(352)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, data.ndim, *data.shape,
                     *([1] * (7 - data.ndim)))
    struct.pack_into(">h", hdr, 70, 16)
    struct.pack_into(">8f", hdr, 76, 1.0, *pixdim, *([1.0] * (7 - len(pixdim))))
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">ff", hdr, 112, 0.5, 3.0)
    with open(path, "wb") as f:
        f.write(bytes(hdr) + data.astype(">f4").tobytes(order="F"))


@pytest.mark.parametrize("name,scl", [("a.nii.gz", (1.0, 0.0)),
                                      ("b.nii", (2.0, -1024.0)),
                                      ("c.nii.gz", (0.0, 5.0)),
                                      ("d.nii", (float("nan"), 5.0))])
def test_nifti_read_matches_jax(tmp_path, name, scl):
    data = np.random.default_rng(0).integers(-1000, 2000, (7, 6, 5)).astype(
        np.int16)
    path = str(tmp_path / name)
    _write_nifti(path, data, pixdim=(0.7, 0.8, 1.5), scl=scl)
    got, ref = tnifti.read_nifti(path), jnifti.read_nifti(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (7, 6, 5)
    np.testing.assert_array_equal(got, ref)
    assert tnifti.read_nifti_shape(path) == jnifti.read_nifti_shape(path)
    (a, sa), (b, sb) = (tnifti.read_nifti_spacing(path),
                        jnifti.read_nifti_spacing(path))
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_nifti_big_endian_float_matches_jax(tmp_path):
    data = np.random.default_rng(1).standard_normal((4, 3, 5)).astype(
        np.float32)
    path = str(tmp_path / "be.nii")
    _write_nifti_be(path, data, (0.5, 0.5, 2.0))
    got = tnifti.read_nifti(path)
    np.testing.assert_array_equal(got, jnifti.read_nifti(path))
    np.testing.assert_array_equal(got, data.astype(np.float64) * 0.5 + 3.0)
    assert tnifti.read_nifti_spacing(path)[1] == (0.5, 0.5, 2.0)
    (tmp_path / "bad.nii").write_bytes(b"\0" * 400)
    with pytest.raises(ValueError, match="not a NIfTI-1"):
        tnifti.read_nifti(str(tmp_path / "bad.nii"))


# --- preprocessing ------------------------------------------------------------


def test_hu_normalize_and_crop_pad_match_jax_exactly():
    r = np.random.default_rng(2)
    img = r.integers(-3000, 3000, (9, 11, 7)).astype(np.int16)
    for slope, intercept in ((1.0, -1024.0), (1.3, -1000.5)):
        got = tpp.hu_normalize(torch.from_numpy(img), slope, intercept)
        ref = jpp.hu_normalize(jnp.asarray(img), jnp.float32(slope),
                               jnp.float32(intercept))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    x = r.standard_normal((9, 11, 7)).astype(np.float32)
    for target in ((5, 20, 7), (12, 4, 3), (9, 11, 7)):
        np.testing.assert_array_equal(
            tpp.crop_pad_hwd(torch.from_numpy(x), target).numpy(),
            np.asarray(jpp.crop_pad_hwd(jnp.asarray(x), target)))
    np.testing.assert_array_equal(
        tpp.crop_pad_hwd(torch.from_numpy(x), (4, 13, 8), 0.5).numpy(),
        np.asarray(jpp.crop_pad_hwd(jnp.asarray(x), (4, 13, 8), 0.5)))


@pytest.mark.parametrize("new_shape", [(5, 17, 11), (20, 4, 7), (13, 13, 3),
                                       (9, 13, 11)])
def test_resize_trilinear_matches_jax(new_shape):
    """Shapes that shrink and grow each axis, and the identity."""
    x = np.random.default_rng(3).standard_normal((2, 9, 13, 11)).astype(
        np.float32)
    got = tpp.resize_trilinear(torch.from_numpy(x), new_shape).numpy()
    ref = np.asarray(jpp.resize_trilinear(jnp.asarray(x), new_shape))
    assert got.shape == ref.shape == (2,) + new_shape
    assert _rel(got, ref) <= 1e-6


def test_offline_and_runtime_stages_match_jax():
    r = np.random.default_rng(4)
    img = r.integers(-1500, 2500, (14, 12, 9)).astype(np.int16)
    shape = tpp.spacing_resample_shape((9, 14, 12), (2.0, 0.7, 0.7))
    assert shape == jpp.spacing_resample_shape((9, 14, 12), (2.0, 0.7, 0.7))
    assert shape == (12, 13, 11)   # truncated, not rounded
    got = tpp.preprocess_offline_volume(img, slope=1.0, intercept=-1024.0,
                                        new_shape=shape, device="cpu")
    ref = jpp.preprocess_offline_volume(jnp.asarray(img, jnp.float32),
                                        slope=1.0, intercept=-1024.0,
                                        new_shape=shape)
    assert got.shape == ref.shape and _rel(got.numpy(), ref) <= 1e-6
    v = r.uniform(-1.5, 1.5, (7, 14, 5)).astype(np.float32)
    target = (8, 16, 9)
    want = np.asarray(jpp.preprocess_runtime_volume(jnp.asarray(v), target))
    np.testing.assert_array_equal(
        tpp.preprocess_runtime_volume(v, target, device="cpu").numpy(), want)
    np.testing.assert_array_equal(tpp.preprocess_runtime_numpy(v, target),
                                  want)
    np.testing.assert_array_equal(thost.runtime_volume(v, target),
                                  jhost.runtime_volume(v, target))
    m = r.integers(0, 2, (3, 7, 14, 5)).astype(np.uint8)
    np.testing.assert_array_equal(tpp.preprocess_mask_numpy(m, (8, 10, 6)),
                                  jpp.preprocess_mask_numpy(m, (8, 10, 6)))
    np.testing.assert_array_equal(thost.runtime_mask(m, (5, 16, 3)),
                                  jhost.runtime_mask(m, (5, 16, 3)))


# --- the packed store ---------------------------------------------------------


def _records(seed=5):
    r = np.random.default_rng(seed)
    return [("v0.nii.gz", r.standard_normal((1, 3, 4, 5)).astype(np.float16),
             {"text": "a"}),
            ("v1.nii.gz", r.standard_normal((1, 3, 4, 5)).astype(np.float16),
             {}),
            ("v2.nii.gz", r.standard_normal((3, 7)).astype(np.float32), None),
            ("v3.nii.gz", r.integers(-9, 9, (1, 3, 4, 5)).astype(np.int16),
             {"text": "b"}),
            ("v4.nii.gz", r.standard_normal((1, 3, 4, 5)).astype(np.float16),
             {"text": "c"})]


def _write(mod, root, records, shard_bytes=256):
    with mod.PackedShardWriter(str(root), shard_bytes=shard_bytes) as w:
        for key, arr, meta in records:
            w.append(key, arr, meta=meta)


def _tree_bytes(root):
    return {name: (root / name).read_bytes()
            for name in sorted(os.listdir(root))}


def test_packed_format_is_the_same_in_both_directions(tmp_path):
    recs = _records()
    _write(jpacked, tmp_path / "jax", recs)
    _write(tpacked, tmp_path / "port", recs)
    files = _tree_bytes(tmp_path / "jax")
    assert len(files) > 2     # several shards
    assert files == _tree_bytes(tmp_path / "port")
    for writer, reader in (("jax", tpacked), ("port", jpacked)):
        store = reader.PackedVolumeStore(str(tmp_path / writer))
        assert store.keys() == [k for k, _, _ in recs] and len(store) == 5
        for key, arr, meta in recs:
            got = store.get(key)
            assert got.dtype == arr.dtype
            assert got.tobytes() == arr.tobytes()
            assert store.meta(key) == (meta or {})
            assert all(r["offset"] % 64 == 0 for r in store.records)
        store.close()


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_get_batch_matches_jax(tmp_path, monkeypatch, path):
    recs = _records(6)
    _write(jpacked, tmp_path, recs)
    if path == "native":
        assert native.available(), native.build_error()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    port = tpacked.PackedVolumeStore(str(tmp_path))
    ref = jpacked.PackedVolumeStore(str(tmp_path))
    keys = ["v4.nii.gz", "v0.nii.gz", "v1.nii.gz"]
    for kw in ({}, {"scale": 0.5, "shift": -1.0}):
        got = port.get_batch(keys, threads=2, **kw)
        want = ref.get_batch(keys, **kw)
        assert got.dtype == np.float32 and got.shape == (3, 1, 3, 4, 5)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.get_f32("v3.nii.gz"),
                                  ref.get_f32("v3.nii.gz"))
    out = np.empty((3, 1, 3, 4, 5), np.float32)
    assert port.get_batch(keys, out=out) is out
    np.testing.assert_array_equal(out, ref.get_batch(keys))
    for bad in (np.empty((2, 1, 3, 4, 5), np.float32),
                np.empty((3, 1, 3, 4, 5), np.float64),
                np.empty((3, 1, 3, 4, 10), np.float32)[..., ::2]):
        with pytest.raises(ValueError, match="C-contiguous float32"):
            port.get_batch(keys, out=bad)
    with pytest.raises(ValueError, match="uniform"):
        port.get_batch(["v0.nii.gz", "v2.nii.gz"])
    port.close()
    ref.close()


def test_native_conversions_match_numpy(tmp_path):
    """The library's bulk conversion and raw reads against numpy, and an
    unknown store version refused."""
    assert native.available(), native.build_error()
    r = np.random.default_rng(7)
    for src in (r.standard_normal(200_000).astype(np.float16),
                r.integers(-500, 500, 1000).astype(np.int16),
                r.integers(0, 255, 999).astype(np.uint8)):
        dst = np.empty(src.shape, np.float32)
        native.convert_f32(src, dst, scale=0.25, shift=2.0, threads=3)
        np.testing.assert_array_equal(
            dst, src.astype(np.float32) * np.float32(0.25) + np.float32(2.0))
    path = tmp_path / "raw.bin"
    data = r.integers(0, 255, 4096).astype(np.uint8)
    path.write_bytes(data.tobytes())
    fd = os.open(path, os.O_RDONLY)
    try:
        out = np.zeros(300, np.uint8)
        native.read_batch([fd, fd], [10, 1000], [100, 200], [0, 100], out)
        np.testing.assert_array_equal(out, np.r_[data[10:110],
                                                 data[1000:1200]])
    finally:
        os.close(fd)
    (tmp_path / "index.json").write_text(json.dumps({"version": 2,
                                                     "records": []}))
    with pytest.raises(ValueError, match="version"):
        tpacked.PackedVolumeStore(str(tmp_path))


# --- CT-RATE data sets ----------------------------------------------------------

LABELS = ["Medical material", "Arterial wall calcification", "Cardiomegaly"]


def _ctrate_tree(tmp_path):
    """Five npz volumes in CT-RATE's tree (shapes above and below the small
    target on every axis), a reports CSV and a labels CSV with pandas'
    quirks: an empty Findings_EN cell, "Not given." beside an empty
    Impressions_EN cell, an "NA" cell, a quoted field holding a comma and a
    newline, a path in VolumeName, an empty label cell, and a volume the
    labels CSV lacks."""
    r = np.random.default_rng(8)
    shapes = [(4, 14, 8), (8, 10, 12), (6, 12, 10), (9, 7, 15), (3, 20, 6)]
    names = []
    for i, shape in enumerate(shapes):
        pid, scan = f"{i // 2 + 1}", "ab"[i % 2]
        folder = tmp_path / "tree" / f"train_{pid}" / f"train_{pid}{scan}"
        folder.mkdir(parents=True, exist_ok=True)
        name = f"train_{pid}_{scan}_1"
        np.savez(folder / f"{name}.npz",
                 r.uniform(-1.2, 1.2, shape).astype(np.float32))
        names.append(f"{name}.nii.gz")
    reports = tmp_path / "reports.csv"
    reports.write_text(
        "VolumeName,Findings_EN,Impressions_EN\n"
        f"{names[0]},,imp a\n"
        f"{names[1]},Not given.,\n"
        f"dir/sub/{names[2]},\"Lungs clear, heart\nnormal (size).\","
        "'quoted' impression\n"
        f"{names[3]},NA,Not given.\n"
        f"{names[4]},Not given.,\n", newline="")
    labels = tmp_path / "labels.csv"
    labels.write_text(
        "VolumeName," + ",".join(LABELS) + "\n"
        f"{names[0]},1,0,1\n{names[1]},0,,1\n{names[2]},1,1,0\n"
        f"{names[3]},0,1,0\n")
    return tmp_path / "tree", str(reports), str(labels), names


def _small_target(monkeypatch):
    for host, mod in ((jhost, jdatasets), (thost, tdatasets)):
        monkeypatch.setattr(mod, "runtime_volume", functools.partial(
            host.runtime_volume, target_hwd=SMALL_HWD))


def _same_item(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            assert got[k].shape == ref[k].shape, k
            assert got[k].tobytes() == ref[k].tobytes(), k
        else:
            assert got[k] == ref[k], k


def test_reports_and_labels_read_as_pandas_reads_them(tmp_path):
    _, reports, labels, names = _ctrate_tree(tmp_path)
    got = tdatasets.load_reports(reports)
    assert got == jdatasets.CTReportDataset._load_reports(reports)
    assert got == tdatasets.CTReportDataset._load_reports(reports)
    assert got[names[0]] == "nanimp a"
    assert got[names[1]] == "Not given.nan"
    assert got[names[2]] == ("Lungs clear, heart\nnormal (size)."
                             "'quoted' impression")
    assert got[names[3]] == "nanNot given."
    cols, onehots = tdatasets.load_labels(labels)
    assert cols == LABELS and set(onehots) == set(names[:4])
    assert onehots[names[1]].dtype == np.float32
    assert np.isnan(onehots[names[1]][1])


def test_report_datasets_match_jax(tmp_path, monkeypatch):
    _small_target(monkeypatch)
    tree, reports, labels, _ = _ctrate_tree(tmp_path)
    from vit_exp_tpu.data.tokenizer import HashTokenizer as JaxTok
    from vit_exp_tpu_torch.data.tokenizer import HashTokenizer as Tok

    ref = jdatasets.CTReportDataset(str(tree), reports, tokenizer=JaxTok(),
                                    max_text_len=24,
                                    cache_dir=str(tmp_path / "jcache"))
    got = tdatasets.CTReportDataset(str(tree), reports, tokenizer=Tok(),
                                    max_text_len=24,
                                    cache_dir=str(tmp_path / "tcache"))
    assert got.samples == ref.samples and len(got) == 4   # 80% of 5
    assert ((tmp_path / "tcache" / "image_samples_tpu.txt").read_text()
            == (tmp_path / "jcache" / "image_samples_tpu.txt").read_text())
    for i in range(len(got)):
        _same_item(got[i], ref[i])
    h, w, d = SMALL_HWD
    assert got[0]["image"].shape == (1, d, h, w)
    # the cached list is read back, not walked again
    again = tdatasets.CTReportDataset(str(tree), reports, keep_percent=100,
                                      cache_dir=str(tmp_path / "tcache"))
    assert len(again) == 5
    inf = tdatasets.CTReportInferenceDataset(str(tree), reports, labels,
                                             limit=3)
    jinf = jdatasets.CTReportInferenceDataset(str(tree), reports, labels,
                                              limit=3)
    assert len(inf) == len(jinf) == 3
    assert inf.label_columns == jinf.label_columns == LABELS
    for i in range(3):
        a, b = inf[i], jinf[i]
        np.testing.assert_array_equal(a.pop("onehot"), b.pop("onehot"))
        _same_item(a, b)


def test_pack_dataset_matches_jax_and_reads_back(tmp_path, monkeypatch):
    """The port's packer and JAX's on one tree: the same index and shard
    bytes (shards of ~2 records); the packed data sets over either store
    give the npz data sets' volumes (through float16) and reports."""
    _small_target(monkeypatch)
    tree, reports, labels, names = _ctrate_tree(tmp_path)
    argv = ["--data_folder", str(tree), "--csv_file", reports,
            "--shard_gb", str(3000 / 2**30)]
    jpack.main(argv + ["--out", str(tmp_path / "jax")])
    os.remove(tree / "tmp_cache_data_list" / "image_samples_tpu.txt")
    tpack.main(argv + ["--out", str(tmp_path / "port")])
    files = _tree_bytes(tmp_path / "jax")
    assert "shard_00001.bin" in files
    assert files == _tree_bytes(tmp_path / "port")
    index = json.loads(files["index.json"])
    assert [r["key"] for r in index["records"]] == sorted(names)
    tpack.main(argv + ["--out", str(tmp_path / "lim"), "--limit", "2",
                       "--dtype", "float32"])
    lim = tpacked.PackedVolumeStore(str(tmp_path / "lim"))
    assert len(lim) == 2 and lim.records[0]["dtype"] == "float32"

    npz = tdatasets.CTReportDataset(str(tree), reports, keep_percent=100)
    got = tpacked.CTReportPackedDataset(str(tmp_path / "port"))
    ref = jpacked.CTReportPackedDataset(str(tmp_path / "port"))
    assert got.samples == ref.samples and len(got) == 5
    for i in range(5):
        _same_item(got[i], ref[i])
        a = npz[i]
        np.testing.assert_array_equal(
            got[i]["image"], a["image"].astype(np.float16).astype(np.float32))
        assert got[i]["text"] == a["text"]
    inf = tpacked.CTReportPackedInferenceDataset(str(tmp_path / "jax"),
                                                 labels, reports)
    jinf = jpacked.CTReportPackedInferenceDataset(str(tmp_path / "jax"),
                                                  labels, reports)
    assert len(inf) == len(jinf) == 4
    assert inf.label_columns == jinf.label_columns
    for i in range(4):
        a, b = inf[i], jinf[i]
        np.testing.assert_array_equal(a.pop("onehot"), b.pop("onehot"))
        _same_item(a, b)


def _metadata(tmp_path, rows):
    path = tmp_path / "metadata.csv"
    path.write_text("VolumeName,RescaleSlope,RescaleIntercept,XYSpacing,"
                    "ZSpacing\n" + "".join(
                        f"{n},{s},{i},\"{xy}\",{z}\n"
                        for n, s, i, xy, z in rows))
    return str(path)


def test_preprocess_ctrate_matches_jax(tmp_path, capsys):
    """Two NIfTI files (one without a metadata row) through both CLIs'
    host paths: the npz trees agree within 1e-6; the port's --device path
    raises without a card, and its code, run on the CPU, agrees with the
    host path."""
    r = np.random.default_rng(9)
    src = tmp_path / "src"
    src.mkdir()
    vols = {"train_7_a_1.nii.gz": (r.integers(-1200, 1500, (20, 18, 9)),
                                   (0.7, 0.7, 2.0)),
            "train_7_b_2.nii.gz": (r.integers(-100, 3000, (15, 22, 11)),
                                   (0.9, 0.9, 1.25)),
            "valid_3_a_1.nii.gz": (r.integers(0, 10, (4, 4, 4)),
                                   (1.0, 1.0, 1.0))}
    for name, (data, pix) in vols.items():
        _write_nifti(str(src / name), data.astype(np.int16), pixdim=pix)
    meta = _metadata(tmp_path, [
        ("train_7_a_1.nii.gz", 1, -1024, "[0.7, 0.7]", 2.0),
        ("train_7_b_2.nii.gz", 1.5, -1000, "[0.9, 0.9]", 1.25)])
    base = ["--src", str(src), "--metadata", meta, "--workers", "2"]
    jprep.main(base + ["--out", str(tmp_path / "jax")])
    tprep.main(base + ["--out", str(tmp_path / "port")])
    assert "skip valid_3_a_1.nii.gz: no metadata row" in capsys.readouterr().out
    for rel in ("train_7/train_7a/train_7_a_1.npz",
                "train_7/train_7b/train_7_b_2.npz"):
        got = np.load(tmp_path / "port" / rel)["arr_0"]
        ref = np.load(tmp_path / "jax" / rel)["arr_0"]
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape and _rel(got, ref) <= 1e-6
    assert got.shape == (9, 18, 26)   # int(11·1.25/1.5), int(15·0.9/0.75), ...
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprep.main(base + ["--out", str(tmp_path / "dev"), "--device"])
    row = {"RescaleSlope": "1.5", "RescaleIntercept": "-1000",
           "XYSpacing": "[0.9, 0.9]", "ZSpacing": "1.25"}
    path = tprep.process_file(str(src / "train_7_b_2.nii.gz"), row,
                              str(tmp_path / "cpu"), "train", device="cpu")
    assert _rel(np.load(path)["arr_0"], got) <= 1e-6
    assert tprep._parse_xy_spacing("0.75") == tprep._parse_xy_spacing(
        "[0.75, 0.75]") == jprep._parse_xy_spacing("[0.75, 0.75]") == 0.75


def test_ingest_modules_keep_the_jax_names():
    for port, ref in ((tnifti, jnifti), (tpp, jpp), (thost, jhost),
                      (tpacked, jpacked)):
        public = {n for n in vars(ref) if not n.startswith("_")
                  and callable(getattr(ref, n))
                  and getattr(getattr(ref, n), "__module__", "")
                  == ref.__name__}
        assert public <= set(vars(port)), (port.__name__,
                                           public - set(vars(port)))
    assert tpp.RUNTIME_TARGET_HWD == jpp.RUNTIME_TARGET_HWD
    assert tpp.TARGET_SPACING == jpp.TARGET_SPACING
    assert tpacked.ALIGN == jpacked.ALIGN
