"""CPU parity of the port's real-data training and latents against the JAX
package, on tiny trees made from a seed with numpy: the RadGenome
segmentation data sets and label tables, the mask tools,
``run_train.build_datasets`` for every entry type and alias,
``run_train.main`` over npz, packed and seg/open-seg trees with
``valid_data`` hooks, ``run_zero_shot_seg`` on folders, ``run_latents``
and the retrieval functions; then the page-locked pool and the batch copy
(which on the CPU is no copy) and the CPU rehearsal of chip_smoke.py's
real-data training phases.

Tolerances: data set items, cache files, label tables, binarized masks and
retrieval on equal latents exactly; the resized mask before binarization
within 1e-6 relative (``test_resize_trilinear_matches_jax``'s); the
losses of ``run_train.main`` within 1e-5 relative of JAX's step functions
fed by JAX's loaders and sampler (``test_trainer_matches_jax_steps``'s);
latents within 1e-5 (``test_run_zero_shot_cls_matches_jax``'s); the dice
of ``run_zero_shot_seg`` exactly where no voxel's logit lies within 1e-4
of 0 (``tests/test_torch_seg_eval.py``).  The models run under the fp32
policy on one torch thread, and the runtime crop/pad targets the tiny
arch's shape in both packages.
"""

import functools
import json
import math
import shutil
import sys
import threading
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seg_eval import _assert_dice_close
from tests.test_torch_serve import one_thread  # noqa: F401 -- a fixture
from tests.test_torch_trainer import TINY_ARCH
from vit_exp_tpu.cli import run_latents as jlatents_cli
from vit_exp_tpu.cli import run_train as jrun_train
from vit_exp_tpu.cli import run_zero_shot_seg as jseg_cli
from vit_exp_tpu.core.config import load_config as jax_load_config
from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.data import datasets as jdatasets
from vit_exp_tpu.data import loader as jloader
from vit_exp_tpu.data import mask_tools as jmask
from vit_exp_tpu.data import preprocess_host as jhost
from vit_exp_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from vit_exp_tpu.eval import latents as jlatents
from vit_exp_tpu.models import factory as jfactory
from vit_exp_tpu.models.convert import export_ctclip_state_dict
from vit_exp_tpu.models.ctclip import CTCLIP as JaxCTCLIP
from vit_exp_tpu.train import sampler as jsampler
from vit_exp_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from vit_exp_tpu.train.steps import create_train_state
from vit_exp_tpu.train.steps import make_train_steps as jax_make_train_steps
from vit_exp_tpu_torch.cli import (pack_dataset, run_latents, run_train,
                                   run_zero_shot_seg)
from vit_exp_tpu_torch.core.config import load_config
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data import datasets as tdatasets
from vit_exp_tpu_torch.data import loader as tloader
from vit_exp_tpu_torch.data import mask_tools as tmask
from vit_exp_tpu_torch.data import pinned
from vit_exp_tpu_torch.data import preprocess_host as thost
from vit_exp_tpu_torch.data.packed import CTReportPackedDataset
from vit_exp_tpu_torch.data.tokenizer import load_tokenizer
from vit_exp_tpu_torch.eval import latents as tlatents
from vit_exp_tpu_torch.models import factory as tfactory
from vit_exp_tpu_torch.models.convert import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
ARCH = {k: v for k, v in TINY_ARCH.items()}
RUNTIME_HWD = (ARCH["image_size"], ARCH["image_size"],
               ARCH["temporal_size"])
MASK_DHW = (ARCH["temporal_size"], ARCH["image_size"], ARCH["image_size"])
TEXT_ENCODER = {"hidden_size": 36, "num_hidden_layers": 1,
                "num_attention_heads": 3, "intermediate_size": 32,
                "max_position_embeddings": 512}
N_CLASSES = 3
HEAD = {"n_layers": 2, "mid_dim": 16, "out_dim": 8}
SEG_ARCH = {"use_seg": True, "seg_head": {"n_layers": 2, "mid_dim": 16,
                                          "out_dim": N_CLASSES},
            "use_open_seg": True, "open_seg_head": HEAD,
            "open_text_head": HEAD}
NAMES = {3: "left lung", 1: "heart, whole", 2: "aorta"}
_BATCH_KEYS = ("image", "input_ids", "attention_mask", "seg_mask",
               "prompt_ids", "prompt_mask")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _same_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _tiny_runtime(monkeypatch):
    """Both packages' data sets crop/pad to the tiny arch's shape."""
    for host, mod in ((jhost, jdatasets), (thost, tdatasets)):
        monkeypatch.setattr(mod, "runtime_volume", functools.partial(
            host.runtime_volume, target_hwd=RUNTIME_HWD))
        monkeypatch.setattr(mod, "runtime_mask", functools.partial(
            host.runtime_mask, target_dhw=MASK_DHW))


def write_radgenome(root: Path, n: int = 3, shapes=None, seed: int = 5):
    """RadGenome's layout: ``images/case_{i}.npz`` (D, H, W) float32 and
    ``masks/case_{i}.npz`` (C, D, H, W) uint8 compressed, with
    ``label_names.csv`` (ID, NAME; IDs out of order).  Returns (images,
    masks, table)."""
    r = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        shape = shapes[i] if shapes else MASK_DHW
        np.savez(root / "images" / f"case_{i}.npz",
                 r.uniform(-1.2, 1.2, shape).astype(np.float32))
        np.savez_compressed(root / "masks" / f"case_{i}.npz",
                            (r.random((N_CLASSES,) + shape) > 0.7)
                            .astype(np.uint8))
    table = root / "label_names.csv"
    table.write_text("ID,NAME\n" + "".join(
        f'{i},"{name}"\n' for i, name in NAMES.items()))
    return str(root / "images"), str(root / "masks"), str(table)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A CT-RATE npz tree of 6 volumes (some larger and some smaller than
    the arch), its reports and labels CSVs, the store the port packs from
    it (at the tiny runtime shape), and a RadGenome tree of 3 cases."""
    from vit_exp_tpu_torch.eval.zero_shot import PATHOLOGIES

    tmp = tmp_path_factory.mktemp("realdata")
    r = np.random.default_rng(31)
    names = []
    for i, shape in enumerate([(12, 36, 30), (20, 28, 34), (16, 32, 32),
                               (18, 30, 40), (14, 40, 26), (16, 33, 31)]):
        sub = tmp / "tree" / f"train_{i}" / f"train_{i}a"
        sub.mkdir(parents=True)
        np.savez(sub / f"train_{i}_a_1.npz",
                 r.uniform(-1.2, 1.2, shape).astype(np.float32))
        names.append(f"train_{i}_a_1.nii.gz")
    reports = tmp / "reports.csv"
    reports.write_text("VolumeName,Findings_EN,Impressions_EN\n" + "".join(
        f"{n},finding {i} (left),impression {i}\n"
        for i, n in enumerate(names)))
    labels = tmp / "labels.csv"
    y = (r.random((6, 18)) > 0.5).astype(int)
    y[0], y[1] = 1, 0
    labels.write_text("VolumeName," + ",".join(PATHOLOGIES) + "\n" + "".join(
        n + "," + ",".join(map(str, row)) + "\n" for n, row in zip(names, y)))
    mp = pytest.MonkeyPatch()
    try:
        _tiny_runtime(mp)
        pack_dataset.main(["--data_folder", str(tmp / "tree"), "--csv_file",
                           str(reports), "--out", str(tmp / "store")])
    finally:
        mp.undo()
    images, masks, table = write_radgenome(tmp / "radgenome")
    return dict(tmp=tmp, tree=str(tmp / "tree"), reports=str(reports),
                labels=str(labels), store=str(tmp / "store"), images=images,
                masks=masks, table=table)


# --- the segmentation data sets and label tables ------------------------------


def _copy(src: str, dst: Path) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def test_seg_dataset_items_and_caches_match_jax(trees, tmp_path):
    """Items bit for bit (dtypes too); the cache files the port writes are
    the ones JAX writes; a count mismatch raises JAX's AssertionError."""
    caches = {}
    for side, cls in (("port", tdatasets.CTSegDataset),
                      ("jax", jdatasets.CTSegDataset)):
        img = _copy(trees["images"], tmp_path / side / "images")
        msk = _copy(trees["masks"], tmp_path / side / "masks")
        ds = cls(img, msk)
        caches[side] = [
            (Path(img) / "tmp_cache_data_list" / "image_samples_tpu.txt")
            .read_text().replace(str(tmp_path / side), "ROOT"),
            (Path(msk) / "tmp_cache_mask_list" / "mask_samples_tpu.txt")
            .read_text().replace(str(tmp_path / side), "ROOT")]
        caches[side + "_ds"] = ds
    assert caches["port"] == caches["jax"]
    assert caches["port"][0].count("\n") == 3
    t, j = caches["port_ds"], caches["jax_ds"]
    assert len(t) == len(j) == 3
    for i in range(3):
        _same_items(t[i], j[i])
    assert t[0]["seg_mask"].dtype == np.float32
    # a second construction reads the caches, not the folders
    for sub in ("images", "masks"):
        np.savez(tmp_path / "port" / sub / "case_9.npz", np.zeros(3))
    again = tdatasets.CTSegDataset(str(tmp_path / "port" / "images"),
                                   str(tmp_path / "port" / "masks"))
    assert again.samples == t.samples
    for side, cls in (("port", tdatasets.CTSegDataset),
                      ("jax", jdatasets.CTSegDataset)):
        img = _copy(trees["images"], tmp_path / f"{side}_gap" / "images")
        msk = _copy(trees["masks"], tmp_path / f"{side}_gap" / "masks")
        Path(msk, "case_1.npz").unlink()
        with pytest.raises(AssertionError, match="3 images vs 2 masks"):
            cls(img, msk)


@pytest.mark.parametrize("prompt_type", ["this_region", "this_is"])
def test_open_seg_dataset_items_match_jax(trees, tmp_path, monkeypatch,
                                          prompt_type):
    """Volumes larger and smaller than the arch on each axis go through the
    runtime crop/pad; prompts of every ID in ID order, tokenized once at
    512 tokens."""
    _tiny_runtime(monkeypatch)
    images, masks, table = write_radgenome(
        tmp_path / "rg", shapes=[(12, 36, 30), (20, 28, 34), (16, 32, 32)])
    t = tdatasets.CTOpenSegDataset(images, masks, table,
                                   tokenizer=load_tokenizer(),
                                   seg_mask_prompt_type=prompt_type)
    j = jdatasets.CTOpenSegDataset(images, masks, table,
                                   tokenizer=jax_load_tokenizer(None),
                                   seg_mask_prompt_type=prompt_type)
    assert t.class_ids == j.class_ids == [1, 2, 3]
    assert t.prompt_ids.shape == (3, 512)
    for i in range(3):
        _same_items(t[i], j[i])
        assert t[i]["image"].shape == (1,) + MASK_DHW
        assert t[i]["seg_mask"].shape == (N_CLASSES,) + MASK_DHW


def test_load_label_names_csv_matches_jax(tmp_path):
    """IDs out of order, a quoted name with a comma, an empty name (NaN
    in pandas: "nan") and a float-typed ID column."""
    path = tmp_path / "names.csv"
    path.write_text('ID,NAME,OTHER\n7,"lung, left",x\n2,heart,\n'
                    '5,,y\n11,aorta (asc.),z\n')
    got = tdatasets.load_label_names(str(path))
    assert got == jdatasets.load_label_names(str(path))
    assert got == {7: "lung, left", 2: "heart", 5: "nan", 11: "aorta (asc.)"}
    path.write_text("ID,NAME\n1.0,a\n3.0,b\n")
    assert (tdatasets.load_label_names(str(path))
            == jdatasets.load_label_names(str(path)) == {1: "a", 3: "b"})


def _xlsx(path: Path, rows, inline_row: int = 2) -> None:
    """A minimal xlsx workbook (the parts Excel writes): one sheet whose
    text cells are shared strings, except row ``inline_row``'s name,
    written as an inline string; numbers as numeric cells."""
    shared, cells = [], []
    for r, row in enumerate(rows, 1):
        out = []
        for c, value in zip("ABC", row):
            ref = f"{c}{r}"
            if isinstance(value, (int, float)):
                out.append(f'<c r="{ref}"><v>{value}</v></c>')
            elif r == inline_row and c == "B":
                out.append(f'<c r="{ref}" t="inlineStr"><is><t>{value}</t>'
                           f'</is></c>')
            else:
                shared.append(value)
                out.append(f'<c r="{ref}" t="s"><v>{len(shared) - 1}</v></c>')
        cells.append(f'<row r="{r}">{"".join(out)}</row>')
    main = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    rel = ("http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/workbook.xml", f'<workbook xmlns="{main}" xmlns:r='
                   f'"{rel}"><sheets><sheet name="labels" sheetId="1" '
                   f'r:id="rId1"/></sheets></workbook>')
        z.writestr("xl/_rels/workbook.xml.rels",
                   '<Relationships xmlns="http://schemas.openxmlformats.org/'
                   'package/2006/relationships"><Relationship Id="rId1" '
                   f'Type="{rel}/worksheet" Target="worksheets/sheet1.xml"/>'
                   '</Relationships>')
        z.writestr("xl/sharedStrings.xml", f'<sst xmlns="{main}">' + "".join(
            f"<si><t>{s}</t></si>" for s in shared) + "</sst>")
        z.writestr("xl/worksheets/sheet1.xml", f'<worksheet xmlns="{main}">'
                   f'<sheetData>{"".join(cells)}</sheetData></worksheet>')


def test_load_label_names_xlsx_reads_as_its_csv_twin(tmp_path):
    """The port reads a hand-built xlsx as JAX (pandas) reads the same
    table as CSV."""
    rows = [("ID", "NAME", "NOTE"), (4, "left lung", "a"), (1, "heart", "b"),
            (9, "trachea &amp; bronchi", "c")]
    _xlsx(tmp_path / "names.xlsx", rows)
    (tmp_path / "names.csv").write_text(
        "ID,NAME,NOTE\n4,left lung,a\n1,heart,b\n9,trachea & bronchi,c\n")
    got = tdatasets.load_label_names(str(tmp_path / "names.xlsx"))
    assert got == jdatasets.load_label_names(str(tmp_path / "names.csv"))
    assert got[9] == "trachea & bronchi"
    columns, table = tdatasets.read_xlsx_rows(str(tmp_path / "names.xlsx"))
    assert columns == ["ID", "NAME", "NOTE"] and len(table) == 3


# --- the mask tools -------------------------------------------------------------


@pytest.mark.parametrize("shape,target", [
    ((2, 9, 11, 7), (7, 9, 11)),      # cubic-free, same voxels reordered
    ((2, 8, 8, 8), (8, 8, 8)),        # cubic: still transposed
    ((3, 10, 12, 6), (9, 8, 14)),     # resized on every axis
])
def test_align_mask_to_image_matches_jax(shape, target):
    r = np.random.default_rng(7)
    mask = (r.random(shape) > 0.8).astype(np.uint8)
    if shape[1:] == (8, 8, 8):
        mask[:, 0, 1, 2] = 1
        mask[:, 2, 1, 0] = 0
    got = tmask.align_mask_to_image(mask, target, device="cpu")
    ref = jmask.align_mask_to_image(mask, target)
    assert got.dtype == np.float32 and got.shape == (shape[0],) + target
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, mask.astype(np.float32)) or \
        shape[1:] != (8, 8, 8)
    reordered = tmask.reorder_mask(mask)
    np.testing.assert_array_equal(reordered, jmask.reorder_mask(mask))
    if reordered.shape[1:] != target:
        before = tmask._resize_mask_trilinear(reordered, target, "cpu")
        ref_before = jmask._resize_mask_trilinear(reordered, target)
        assert _rel(before, ref_before) <= 1e-6
        nb = tmask.align_mask_to_image(mask, target, binarize=False,
                                       device="cpu")
        assert _rel(nb, jmask.align_mask_to_image(
            mask, target, binarize=False)) <= 1e-6
    no_reorder = tmask.align_mask_to_image(
        np.transpose(mask, (0, 3, 1, 2)), target, reorder=False,
        device="cpu")
    np.testing.assert_array_equal(no_reorder, got)


@pytest.mark.parametrize("z_flip,xy_transpose",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_flip_mask_by_metadata_matches_jax(z_flip, xy_transpose):
    mask = np.random.default_rng(8).random((2, 5, 6, 7)).astype(np.float32)
    got = tmask.flip_mask_by_metadata(mask, z_flip=z_flip,
                                      xy_transpose=xy_transpose)
    ref = jmask.flip_mask_by_metadata(mask, z_flip=z_flip,
                                      xy_transpose=xy_transpose)
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, ref)


def test_tree_tools_match_jax(tmp_path):
    """check_npz_tree names the corrupt file; compare_name_sets (with a
    strip) as JAX's; copy_tree_parallel copies, then resumes with nothing
    to do, then copies a changed file again."""
    img, msk = tmp_path / "img" / "a", tmp_path / "msk"
    img.mkdir(parents=True)
    msk.mkdir()
    for name in ("x_1.npz", "y_1.npz"):
        np.savez(img / name, np.zeros(3))
    for name in ("y_1.npz", "z_1.npz"):
        np.savez(msk / name, np.zeros(2))
    (img / "bad.npz").write_bytes(b"not a zip")
    got = tmask.check_npz_tree(str(tmp_path), workers=2)
    assert got.keys() == jmask.check_npz_tree(str(tmp_path), 2).keys() == {
        str(img / "bad.npz")}
    strip = lambda n: n.replace("_1.npz", "")   # noqa: E731
    assert (tmask.compare_name_sets(str(tmp_path / "img"), str(msk), strip)
            == jmask.compare_name_sets(str(tmp_path / "img"), str(msk),
                                       strip)
            == {"img_only": ["bad.npz", "x"], "mask_only": ["z"],
                "common": ["y"]})
    for side, fn in (("t", tmask.copy_tree_parallel),
                     ("j", jmask.copy_tree_parallel)):
        dst = tmp_path / f"copy_{side}"
        assert fn(str(tmp_path / "img"), str(dst), workers=2) == 3
        assert fn(str(tmp_path / "img"), str(dst), workers=2) == 0
        (dst / "a" / "x_1.npz").write_bytes(b"short")
        assert fn(str(tmp_path / "img"), str(dst), workers=2) == 1
        assert (dst / "a" / "x_1.npz").read_bytes() == \
            (img / "x_1.npz").read_bytes()


# --- run_train's data sets --------------------------------------------------------


def _spec_cases(t):
    return {
        "npz": {"type": "imagereport", "data_folder": t["tree"],
                "reports_csv": t["reports"]},
        "npz, reference names": {"type": "imagereport",
                                 "data_train": t["tree"],
                                 "reports_file_train": t["reports"]},
        "packed": {"type": "imagereport", "packed": True,
                   "data_folder": t["store"]},
        "packed, reference names": {"type": "imagereport", "packed": True,
                                    "data_train": t["store"],
                                    "reports_file_train": t["reports"]},
        "seg": {"type": "imageseg", "data_folder": t["images"],
                "mask_folder": t["masks"]},
        "seg, reference names": {"type": "imageseg",
                                 "seg_data_train": t["images"],
                                 "seg_mask_train": t["masks"]},
        "open-seg": {"type": "imageopenseg", "data_folder": t["images"],
                     "mask_folder": t["masks"],
                     "seg_mask_name_table": t["table"]},
        "open-seg, reference names": {
            "type": "imageopenseg", "seg_data_train": t["images"],
            "seg_mask_train": t["masks"], "seg_mask_name_table": t["table"],
            "seg_mask_prompt_type": "this_is"},
    }


def _configs_for(tmp_path, specs, **extra):
    cfg = {"random_seed": 0, "results_folder": str(tmp_path / "run"),
           "arch": ARCH, "dim_latent": 16, "text_encoder": TEXT_ENCODER,
           "train_data_list": specs, **extra}
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("case", ["npz", "npz, reference names", "packed",
                                  "packed, reference names", "seg",
                                  "seg, reference names", "open-seg",
                                  "open-seg, reference names"])
def test_build_datasets_matches_jax(trees, tmp_path, monkeypatch, case):
    """Item for item (every item of the set), and the type of data set."""
    _tiny_runtime(monkeypatch)
    spec = _spec_cases(trees)[case]
    path = _configs_for(tmp_path, [spec])
    (t,) = run_train.build_datasets(load_config(path), load_tokenizer())
    (j,) = jrun_train.build_datasets(jax_load_config(path),
                                     jax_load_tokenizer(None))
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        _same_items(t[i], j[i])


@pytest.mark.parametrize("spec", [
    {"type": "imagereport"}, {"type": "imagereport", "data_folder": "x"},
    {"type": "imageseg", "data_folder": "x"},
    {"type": "imageopenseg", "data_folder": "x", "mask_folder": "y"}],
    ids=["no folder", "no csv", "no masks", "no table"])
def test_build_datasets_raises_jaxs_key_error(tmp_path, spec):
    path = _configs_for(tmp_path, [spec])
    for build, load, tok in ((run_train.build_datasets, load_config,
                              load_tokenizer()),
                             (jrun_train.build_datasets, jax_load_config,
                              jax_load_tokenizer(None))):
        with pytest.raises(KeyError, match="dataset spec needs one of"):
            build(load(path), tok)


def test_packed_batch_read_in_one_call_is_the_items_collated(trees):
    """CTReportPackedDataset.collate_batch (one native read into the batch
    array, or into the arrays ``alloc`` gives) against the items
    collated, and against JAX's items."""
    tok = load_tokenizer()
    ds = CTReportPackedDataset(trees["store"], tokenizer=tok)
    from vit_exp_tpu.data.packed import CTReportPackedDataset as JaxPacked

    jds = JaxPacked(trees["store"], tokenizer=jax_load_tokenizer(None))
    idx = [4, 0, 2]
    want = jloader.collate([jds[i] for i in idx])
    _same_items(ds.collate_batch(idx), want)
    arrays = {}

    def alloc(key, shape, dtype):
        arrays[key] = np.full(shape, 7, dtype)
        return arrays[key]

    got = ds.collate_batch(idx, alloc=alloc)
    _same_items(got, want)
    assert got["image"] is arrays["image"]


# --- run_train.main on real folders -------------------------------------------------


def _params(config_path, seed=3):
    """Perturbed fp32 parameters of the JAX model of the config (its text
    encoder and heads)."""
    import flax.linen as nn

    config = jax_load_config(config_path)
    bert = jfactory.bert_config_for(config, jax_load_tokenizer(None))
    model = jfactory.build_ctclip(config, bert_config=bert, policy=JAX_FP32)
    a = config.arch
    video = jnp.zeros((1, 1, a.temporal_size, a.image_size, a.image_size))
    params = nn.unbox(jax.jit(lambda k: model.init(
        k, video, jnp.ones((1, 8), jnp.int32),
        method=JaxCTCLIP.init_all))(jax.random.PRNGKey(seed)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + np.float32(0.05)
        * rng.standard_normal(np.shape(p)).astype(np.float32), params)


def _jax_lines(config_path, params, steps):
    """The per-step metric lines JAX's trainer would log (each data set's
    last micro-step), from JAX's step functions on one shard fed by JAX's
    loaders and sampler."""
    config = jax_load_config(config_path)
    tok = jax_load_tokenizer(None)
    model = jfactory.build_ctclip(
        config, bert_config=jfactory.bert_config_for(config, tok),
        policy=JAX_FP32, attn_impl="pallas", ff_impl="pallas")
    tx = jax_build_optimizer(config.trainer)
    fns = jax_make_train_steps(model, tx, config, n_data_shards=1)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                               tx)
    specs = config.train_data_list
    loaders = [jloader.InfiniteLoader(jloader.Loader(
        ds, batch_size=spec["batch_size"], shuffle=True,
        seed=config.random_seed, drop_last=True))
        for spec, ds in zip(specs, jrun_train.build_datasets(config, tok))]
    sampler = jsampler.build_dataset_sampler(config.dataset_sampler,
                                             seed=config.random_seed)
    balance = list(config.trainer.balance_loss_weight) or [1.0] * len(specs)
    lines = []
    for step in range(steps):
        logs = {}
        for ds_idx, n in enumerate(sampler.sample(step)):
            for _ in range(n):
                b = next(loaders[ds_idx])
                state, m = fns[specs[ds_idx].get("type", "imagereport")](
                    state, {k: jnp.asarray(np.asarray(b[k]))
                            for k in _BATCH_KEYS if k in b},
                    float(balance[ds_idx]))
                logs.update({f"ds{ds_idx}_{k}": float(v)
                             for k, v in m.items()})
        lines.append(logs)
    return lines


def _port_builds(monkeypatch, params):
    """run_train builds its model under the fp32 policy with ``params``."""
    inner = tfactory.build_ctclip

    def build(*args, **kwargs):
        model = inner(*args, **{**kwargs, "policy": FP32_POLICY})
        res = model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                     from_jax_params(params).items()})
        assert not res.missing_keys and not res.unexpected_keys
        return model

    monkeypatch.setattr(tfactory, "build_ctclip", build)


RUN_CASES = {
    "npz": ([{"type": "imagereport", "data_train": "{tree}",
              "reports_file_train": "{reports}", "batch_size": 2,
              "num_workers": 2}], [2], {}),
    "packed": ([{"type": "imagereport", "packed": True,
                 "data_folder": "{store}", "batch_size": 2,
                 "num_workers": 2}], [1], {}),
    "seg and open-seg": (
        [{"type": "imagereport", "data_folder": "{tree}",
          "reports_csv": "{reports}", "batch_size": 2, "num_workers": 2},
         {"type": "imageseg", "seg_data_train": "{images}",
          "seg_mask_train": "{masks}", "batch_size": 1, "num_workers": 2},
         {"type": "imageopenseg", "data_folder": "{images}",
          "mask_folder": "{masks}", "seg_mask_name_table": "{table}",
          "batch_size": 1, "num_workers": 1}], [1, 1, 1],
        {"ct_clip_arch": SEG_ARCH,
         "valid_test_list": ["zero_shot_cls_valid", "seg_test_valid"],
         "sample_test_list": ["open_seg_valid"],
         "valid_data": {"cls": {"data_folder": "{tree}",
                                "reports_csv": "{reports}",
                                "labels_csv": "{labels}"},
                        "seg": {"data_folder": "{images}",
                                "mask_folder": "{masks}"},
                        "open_seg": {"data_folder": "{images}",
                                     "mask_folder": "{masks}",
                                     "seg_mask_name_table": "{table}"}}}),
}


def _fill(obj, t):
    if isinstance(obj, str):
        return obj.format(**t)
    if isinstance(obj, dict):
        return {k: _fill(v, t) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fill(v, t) for v in obj]
    return obj


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_train_on_real_folders_matches_jax(trees, tmp_path, monkeypatch,
                                               one_thread, case):
    """Two optimizer steps of run_train.main from JAX's parameters: every
    logged loss within 1e-5 of JAX's step functions on JAX's batches; on
    the seg case the valid_data hooks run at step 2 (finite lines, PNGs)
    and the git state is written."""
    _tiny_runtime(monkeypatch)
    specs, acc, extra = RUN_CASES[case]
    path = _configs_for(
        tmp_path, _fill(specs, trees),
        trainer={"lr": 1e-4, "wd": 0.01, "max_grad_norm": 0.05,
                 "num_train_steps": 2, "save_model_every": 0,
                 "eval_model_every": 2, "sample_val_every": 2},
        DatasetSampler={"type": "Combined", "acc_steps_list": acc},
        **_fill(extra, trees))
    params = _params(path)
    ref = _jax_lines(path, params, 2)
    _port_builds(monkeypatch, params)
    trainer = run_train.main(["--config", path, "--debug"], device="cpu")
    assert trainer.status == "completed" and trainer.step == 2
    # no batch was read ahead past the last step
    assert trainer.batches == 2 * sum(acc)
    lines = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    train = [d for d in lines if "ds0_loss" in d]
    assert [d["step"] for d in train] == [1, 2]
    for got, want in zip(train, ref):
        assert set(want) <= set(got)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-5), k
    assert (tmp_path / "run" / "git_state.txt").exists()
    if extra:
        evals = {k: v for d in lines for k, v in d.items()
                 if k.startswith(("eval/", "sample/"))}
        assert math.isfinite(evals["eval/zero_shot_cls_valid/mean_auc"])
        assert math.isfinite(evals["eval/seg_test_valid/mean_dice"])
        pngs = [v for k, v in evals.items() if k.startswith("sample/")]
        assert pngs and all(Path(p).stat().st_size for p in pngs)
    trainer.close()


# --- run_zero_shot_seg on folders, run_latents ----------------------------------------


def _reference_pt(config_path, tmp_path, seed=4):
    """A CTClip.*.pt exported from the JAX model's perturbed parameters."""
    config = jax_load_config(config_path)
    a = config.arch
    sd = export_ctclip_state_dict(
        _params(config_path, seed), heads=a.heads,
        grid=(a.temporal_size // a.temporal_patch_size,
              a.image_size // a.patch_size, a.image_size // a.patch_size),
        bert_config=jfactory.bert_config_for(config,
                                             jax_load_tokenizer(None)))
    pt = tmp_path / f"CTClip.{seed}.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    return str(pt)


def _fp32_builds(monkeypatch):
    monkeypatch.setattr(jfactory, "build_ctclip", functools.partial(
        jfactory.build_ctclip, policy=JAX_FP32))
    monkeypatch.setattr(tfactory, "build_ctclip", functools.partial(
        tfactory.build_ctclip, policy=FP32_POLICY))


def test_run_zero_shot_seg_on_folders_matches_jax(trees, tmp_path,
                                                  monkeypatch, one_thread):
    """--no-int8 on a reference checkpoint: the per-sample dice of JAX's
    CLI (exact where no logit is near the threshold), the JSON's keys; the
    CLI's result is the in-memory engine's on the same arrays."""
    path = _configs_for(tmp_path, [], ct_clip_arch={
        "use_seg": True, "seg_head": SEG_ARCH["seg_head"]})
    pt = _reference_pt(path, tmp_path)
    _fp32_builds(monkeypatch)
    argv = ["--config", path, "--no-int8", "--torch_ckpt", "--model_path",
            pt, "--data_folder", trees["images"], "--mask_folder",
            trees["masks"]]
    ref = None
    jseg_cli.main(argv + ["--results_folder", str(tmp_path / "jax")])
    got = run_zero_shot_seg.main(
        argv + ["--results_folder", str(tmp_path / "port")], device="cpu")
    ref = np.load(tmp_path / "jax" / "dice_scores.npy")
    per = np.load(tmp_path / "port" / "dice_scores.npy")
    assert per.shape == ref.shape == (3, N_CLASSES)
    from tests.test_torch_seg_eval import MARGIN
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotSegmenter
    from vit_exp_tpu_torch.train.checkpoint import load_model_weights

    config = load_config(path)
    model = tfactory.build_ctclip(
        config, tfactory.bert_config_for(config, load_tokenizer()),
        device="cpu", attn_impl="pallas_static", fuse_qkv=True)
    load_model_weights(model, pt, torch_ckpt=True)
    ds = tdatasets.CTSegDataset(trees["images"], trees["masks"])
    near, union = [], []
    with torch.no_grad():
        for i in range(len(ds)):
            logits = model.seg_forward(torch.from_numpy(ds[i]["image"][None]))
            pred = torch.sigmoid(logits) > 0.5
            near.append((logits.abs() < MARGIN).sum(dim=(2, 3, 4))[0].numpy())
            union.append((pred.sum(dim=(2, 3, 4))[0] + torch.from_numpy(
                ds[i]["seg_mask"]).sum(dim=(1, 2, 3))).numpy())
    _assert_dice_close(per, ref, np.stack(near), np.stack(union))
    memory = [ds[i] for i in range(len(ds))]
    assert ZeroShotSegmenter(model).infer(memory) == got
    assert set(got) == {f"dice_class_{i}" for i in range(N_CLASSES)} | {
        "mean_dice"}


def test_run_zero_shot_seg_without_data_raises_what_jax_raises(tmp_path,
                                                               monkeypatch):
    path = _configs_for(tmp_path, [], ct_clip_arch={
        "use_seg": True, "seg_head": SEG_ARCH["seg_head"]})
    _fp32_builds(monkeypatch)
    argv = ["--config", path, "--no-int8", "--results_folder",
            str(tmp_path / "o")]
    with pytest.raises(TypeError):
        jseg_cli.main(argv)
    with pytest.raises(TypeError):
        run_zero_shot_seg.main(argv, device="cpu")


def test_run_latents_matches_jax(trees, tmp_path, monkeypatch, capsys,
                                 one_thread):
    """--no-int8 on a reference checkpoint over the CT-RATE tree (batch 4
    over 6 volumes leaves a tail of 2): latents within 1e-5, the same
    accessions, the same retrieval; the summary line's keys."""
    _tiny_runtime(monkeypatch)
    _fp32_builds(monkeypatch)
    path = _configs_for(tmp_path, [])
    pt = _reference_pt(path, tmp_path, seed=6)
    argv = ["--config", path, "--no-int8", "--torch_ckpt", "--model_path",
            pt, "--data_folder", trees["tree"], "--reports_csv",
            trees["reports"], "--labels_csv", trees["labels"], "--topk", "2"]
    jlatents_cli.main(argv + ["--results_folder", str(tmp_path / "jax")])
    ref_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = run_latents.main(argv + ["--results_folder",
                                   str(tmp_path / "port")], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got and set(got) == set(ref_line)
    assert got["n"] == ref_line["n"] == 6
    assert got["report_to_volume_recall_at_k"] == \
        ref_line["report_to_volume_recall_at_k"]
    assert got["v2v_mean_top1_sim"] == pytest.approx(
        ref_line["v2v_mean_top1_sim"], abs=1e-5)
    t, j = (np.load(tmp_path / s / "latents.npz") for s in ("port", "jax"))
    for k in ("image_latents", "text_latents"):
        assert t[k].shape == j[k].shape == (6, 16)
        np.testing.assert_allclose(t[k], j[k], atol=1e-5, rtol=0)
    assert ((tmp_path / "port" / "accessions.txt").read_text()
            == (tmp_path / "jax" / "accessions.txt").read_text())
    for name in ("volume_to_volume.npz", "report_to_volume.npz"):
        a, b = (np.load(tmp_path / s / name) for s in ("port", "jax"))
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_allclose(a["similarities"], b["similarities"],
                                   atol=1e-5)


def test_dump_encodings_matches_jax(trees, tmp_path, monkeypatch,
                                    one_thread):
    """The image tower's tokens per accession, within 1e-5, on the same
    weights through both engines."""
    _tiny_runtime(monkeypatch)
    path = _configs_for(tmp_path, [])
    params = _params(path, seed=7)
    jconfig = jax_load_config(path)
    jtok = jax_load_tokenizer(None)
    jmodel = jfactory.build_ctclip(
        jconfig, bert_config=jfactory.bert_config_for(jconfig, jtok),
        policy=JAX_FP32)
    from vit_exp_tpu.eval.zero_shot import ZeroShotClassifier as JaxEngine
    from vit_exp_tpu_torch.eval.zero_shot import ZeroShotClassifier

    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                     jtok, batch_size=4)
    jds = jdatasets.CTReportInferenceDataset(
        trees["tree"], trees["reports"], trees["labels"])
    _port_builds(monkeypatch, params)
    config = load_config(path)
    tok = load_tokenizer()
    model = tfactory.build_ctclip(config, tfactory.bert_config_for(
        config, tok), device="cpu", attn_impl="pallas_static", fuse_qkv=True)
    eng = ZeroShotClassifier(model, tok, batch_size=4)
    ds = tdatasets.CTReportInferenceDataset(
        trees["tree"], trees["reports"], trees["labels"])
    ref = jlatents.dump_encodings(jeng, jds, str(tmp_path / "jax"),
                                  num_workers=1)
    got = tlatents.dump_encodings(eng, ds, str(tmp_path / "port"),
                                  num_workers=1)
    assert [Path(p).name for p in got] == [Path(p).name for p in ref]
    assert len(got) == 6 and got[0].endswith("train_0_a_1.nii.gz"
                                              ".encodings.npz")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.load(a)["arr_0"], np.load(b)["arr_0"],
                                   atol=1e-5, rtol=0)


def test_retrieval_matches_jax():
    """volume_to_volume (with label overlap), report_to_volume and
    volume_to_report on the same latents: the same numpy, the same
    answers."""
    r = np.random.default_rng(9)
    img = r.standard_normal((7, 5)).astype(np.float32)
    txt = (img + 0.5 * r.standard_normal((7, 5))).astype(np.float32)
    labels = (r.random((7, 4)) > 0.5).astype(np.float32)
    for got, ref in (
            (tlatents.volume_to_volume(img, 3, labels),
             jlatents.volume_to_volume(img, 3, labels)),
            (tlatents.report_to_volume(txt, img, 2),
             jlatents.report_to_volume(txt, img, 2)),
            (tlatents.volume_to_report(img, txt, 4),
             jlatents.volume_to_report(img, txt, 4))):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert tlatents.volume_to_volume(img, 3)["indices"].shape == (7, 3)


def test_make_synth_shards_torch_writes_the_jax_scripts_bytes(tmp_path):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import make_synth_shards as jscript
        import make_synth_shards_torch as tscript
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    argv = ["--n", "3", "--shape", "6,8,5", "--seed", "2"]
    jscript.main(argv + ["--out", str(tmp_path / "jax")])
    assert tscript.main(argv + ["--out", str(tmp_path / "port")]) == str(
        tmp_path / "port")
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in files:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    ds = CTReportPackedDataset(str(tmp_path / "port"))
    assert len(ds) == 3 and ds[1]["image"].shape == (1, 6, 8, 5)


# --- the page-locked pool and the batch copy ----------------------------------------


class _Items:
    """Items of distinct bytes, made slowly enough that workers overlap."""

    def __init__(self, n, shape=(3, 5)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        threading.Event().wait(0.002 * (i % 3))
        return {"image": np.full(self.shape, i, np.float32),
                "ids": np.arange(4, dtype=np.int32) + i,
                "name": f"item{i}"}


def test_pooled_loader_yields_the_plain_loaders_batches():
    """More workers than slots, two epochs, a short tail: each batch's
    indices and bytes are the plain loader's; the pooled keys live in the
    pool's slots and the rest in fresh memory."""
    ds = _Items(23)
    kw = dict(shuffle=True, seed=3, num_workers=5, prefetch=2)
    pool = pinned.PinnedPool(2, ("image",), register=False)
    plain, pooled = tloader.Loader(ds, 4, **kw), tloader.Loader(
        ds, 4, pool=pool, **kw)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(2):
            want = [{k: np.copy(v) if isinstance(v, np.ndarray) else v
                     for k, v in b.items()} for b in plain]
            got = []
            for b in pooled:
                assert isinstance(b, pinned.HostBatch)
                got.append({k: np.copy(v) if isinstance(v, np.ndarray)
                            else v for k, v in b.items()})
            assert len(got) == len(want) == 6
            for a, b in zip(got, want):
                _same_items(a, b)
    finally:
        sys.setswitchinterval(switch)
    pooled.close()


def test_pool_slot_waits_for_the_batch_before_it():
    """seq k takes its slot only after seq k − slots released it; a set
    stop frees a waiting worker with Stopped."""
    pool = pinned.PinnedPool(2, ("image",), register=False)
    pool.acquire(0)
    pool.acquire(1)
    took = []
    t = threading.Thread(target=lambda: took.append(pool.acquire(2)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive() and not took
    pool.release(1)            # the wrong slot: seq 2 still waits
    t.join(timeout=0.3)
    assert t.is_alive()
    pool.release(0)
    t.join(timeout=5)
    assert not t.is_alive() and len(took) == 1
    pool.release(0)            # a second release is a no-op
    stop = threading.Event()
    errors = []

    def wait():
        try:
            pool.acquire(4, stop)
        except pinned.Stopped:
            errors.append("stopped")

    t = threading.Thread(target=wait)
    t.start()
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive() and errors == ["stopped"]


def test_abandoned_pooled_iteration_does_not_block_the_next():
    ds = _Items(12)
    loader = tloader.Loader(ds, 2, num_workers=3,
                            pool=pinned.PinnedPool(2, ("image",),
                                                   register=False))
    it = iter(loader)
    first = next(it)
    assert first["name"] == ["item0", "item1"]
    del it                     # abandoned mid-epoch, its slots held
    batches = list(loader)
    assert [b["name"][0] for b in batches] == [f"item{i}"
                                               for i in range(0, 12, 2)]
    loader.close()
    assert next(iter(loader))["name"] == ["item0", "item1"]


def test_batch_copier_on_the_cpu_shares_memory_and_releases():
    """On the CPU the tensors are the host arrays (no copy) and the batch's
    slot is given back at once."""
    released = []
    batch = pinned.HostBatch(image=np.ones((2, 3), np.float32),
                             ids=np.arange(4), text=["a", "b"])
    batch.release = lambda event=None: released.append(event)
    out = pinned.BatchCopier("cpu").to_device(batch, ("image", "ids",
                                                      "mask"))
    assert set(out) == {"image", "ids"} and released == [None]
    out["image"][0, 0] = 5
    assert batch["image"][0, 0] == 5


# --- the CPU rehearsal of chip_smoke.py's real-data training phases ------------------


def test_chip_smoke_real_training_phases_rehearse_on_cpu(tmp_path,
                                                         monkeypatch,
                                                         one_thread):
    """chip_smoke's real-format training phases at the tiny arch on the
    CPU (every wrapper runs its plain twin, so no launch is counted): the
    RadGenome tree and the synthetic store written, run_train on the three
    config copies with the byte check of the batches and the copy timing,
    run_zero_shot_seg on the folders against the in-memory engine, and
    run_latents against the engine's own encoders; then the result
    lines."""
    import chip_smoke as cs

    _tiny_runtime(monkeypatch)
    monkeypatch.setattr(tfactory, "build_ctclip", functools.partial(
        tfactory.build_ctclip, policy=FP32_POLICY))
    overrides = {"arch": ARCH, "dim_latent": 16,
                 "text_encoder": TEXT_ENCODER}
    none = cs.expected_launches({})
    out = cs.real_training_phase(
        torch.device("cpu"), tmp_path, none, none, none,
        overrides=overrides, ctrate_dhw=[(12, 36, 30), (20, 28, 34),
                                         (16, 32, 32), (18, 30, 40),
                                         (14, 40, 26), (16, 33, 31)],
        radgenome_dhw=MASK_DHW, store_shape=MASK_DHW, n_classes=N_CLASSES)
    runs = out["runs"]
    assert list(runs) == list(cs.REAL_TRAIN_CONFIGS)
    for name, r in runs.items():
        assert r["steps"] == cs.REAL_TRAIN_STEPS
        assert r["checked"] and all(n > 0 for n in r["checked"].values())
        assert set(r["copy_ms"]) == set(r["types"])
    assert out["seg"]["res"] == out["seg"]["memory"]
    assert out["latents"]["bitwise"] and out["latents"]["summary"]["n"] == 6
    lines = cs.real_training_lines(out, "card X")
    assert lines and all(x.endswith("on card X") for x in lines)
