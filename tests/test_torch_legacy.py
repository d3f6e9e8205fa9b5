"""CPU parity of the port's legacy pieces against the JAX package: the
fallback towers (models/fallback.py), the video data (data/video.py) and
the BPE tokenizers (data/bpe.py), at tiny sizes:

- TextTransformer (absolute positions, rotary, causal) and
  VisionTransformer from JAX's parameters, fp32: 2e-5 absolute, the
  tolerance of the JAX package's own torch oracle (tests/test_fallback.py);
  the static patch dropout on the same normal scores as lax.top_k: bit
  for bit;
- ``write_nifti`` read back by both packages' readers: bit for bit; the
  reference resample, the trilinear resample and ``load_hu_volume`` (the
  PNMS slice reversal, the HU window): 1e-6 absolute;
- ``VideoTextDataset``, ``VideoDataset`` and ``VideoTextSuperresDataset``
  over a tiny csv-joined tree: the same items as JAX's (pandas') data
  sets, texts equal and volumes within 1e-6; an xlsx report table (which
  pandas reads only with openpyxl) as its csv twin; ``video_to_gif``;
- the CLIP and the byte-level BPE tokenizers: the same ids as JAX's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.data import bpe as jbpe
from vit_exp_tpu.data import video as jvideo
from vit_exp_tpu.data.nifti import read_nifti as jax_read_nifti
from vit_exp_tpu.models import fallback as jfb

from tests.test_data_tools import _write_nifti
from tests.test_torch_ctvit import _np, _t
from tests.test_torch_realdata import _xlsx
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data import bpe as tbpe
from vit_exp_tpu_torch.data import video as tvideo
from vit_exp_tpu_torch.data.nifti import read_nifti
from vit_exp_tpu_torch.models import fallback as tfb
from vit_exp_tpu_torch.models.convert import from_jax_fallback_params

DIM, DH, HEADS, DEPTH = 24, 8, 2, 2


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            from_jax_fallback_params(params).items()},
                           strict=True)
    return module


@pytest.mark.parametrize("rotary,causal", [(False, False), (True, False),
                                           (False, True)])
def test_text_transformer_matches_jax(rotary, causal):
    vocab, max_len, n, b = 50, 16, 9, 2
    ids = np.random.default_rng(0).integers(0, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    mask[0, -3:] = 0
    jmodel = jfb.TextTransformer(dim=DIM, num_tokens=vocab,
                                 max_seq_len=max_len, depth=DEPTH,
                                 dim_head=DH, heads=HEADS,
                                 rotary_pos_emb=rotary, causal=causal,
                                 policy=JAX_FP32)
    params = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(ids),
                                      jnp.asarray(mask)))["params"]
    ref = jmodel.apply({"params": params}, jnp.asarray(ids),
                       jnp.asarray(mask))
    model = _load(tfb.TextTransformer(
        DIM, vocab, max_len, depth=DEPTH, dim_head=DH, heads=HEADS,
        rotary_pos_emb=rotary, causal=causal, policy=FP32_POLICY,
        device="cpu"), params)
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=2e-5)


def test_vision_transformer_and_patch_dropout_match_jax():
    images = np.random.default_rng(1).normal(size=(2, 3, 16, 16)).astype(
        np.float32)
    jmodel = jfb.VisionTransformer(dim=DIM, image_size=16, patch_size=4,
                                   depth=DEPTH, dim_head=DH, heads=HEADS,
                                   policy=JAX_FP32)
    params = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                      jnp.asarray(images)))["params"]
    ref = jmodel.apply({"params": params}, jnp.asarray(images))
    model = _load(tfb.VisionTransformer(DIM, 16, 4, depth=DEPTH, dim_head=DH,
                                        heads=HEADS, policy=FP32_POLICY,
                                        device="cpu"), params)
    out = model(torch.from_numpy(images))
    assert out.shape == (2, 17, DIM)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=2e-5)
    # the dropout is JAX's PatchDropout body on the same scores, ties too
    x = np.random.default_rng(2).normal(size=(2, 16, DIM)).astype(np.float32)
    scores = np.round(np.random.default_rng(3).normal(size=(2, 16)), 1)
    keep = max(1, int(16 * (1 - 0.5)))
    _, idx = jax.lax.top_k(jnp.asarray(scores, jnp.float32), keep)
    ref = np.take_along_axis(x, np.asarray(idx)[..., None], axis=1)
    out = tfb.patch_dropout(_t(x), 0.5, _t(scores.astype(np.float32)))
    np.testing.assert_array_equal(out.numpy(), ref)
    dropped = model(torch.from_numpy(images), keep_all_patches=False,
                    deterministic=False,
                    generator=torch.Generator().manual_seed(0))
    assert dropped.shape == (2, 1 + keep, DIM)


def test_nifti_writer_and_resampling_match_jax(tmp_path):
    vol = np.random.default_rng(0).normal(size=(6, 5, 4)).astype(np.float32)
    path = str(tmp_path / "out.nii.gz")
    tvideo.write_nifti(path, vol, spacing=(0.5, 0.75, 2.0))
    np.testing.assert_array_equal(read_nifti(path), vol)
    np.testing.assert_array_equal(jax_read_nifti(path), vol)
    jpath = str(tmp_path / "jax.nii.gz")
    jvideo.write_nifti(jpath, vol, spacing=(0.5, 0.75, 2.0))
    import gzip

    assert gzip.open(path).read() == gzip.open(jpath).read()
    dhw = np.random.default_rng(1).normal(size=(9, 20, 14)).astype(np.float32)
    for target in ((5, 8, 8), (13, 25, 30)):
        np.testing.assert_allclose(
            tvideo.resample_reference(dhw, target),
            jvideo.resample_reference(dhw, target), atol=1e-6)
        np.testing.assert_allclose(tvideo._resample_to(dhw, target),
                                   jvideo._resample_to(dhw, target),
                                   atol=1e-6)
    raw = np.random.default_rng(2).integers(-1200, 1200, (8, 8, 6)).astype(
        np.int16)
    nii = str(tmp_path / "scan.nii.gz")
    _write_nifti(nii, raw)
    for meta in ({"RescaleSlope": 1, "RescaleIntercept": -24,
                  "Manufacturer": "PNMS"}, {}):
        for resample in ("reference", "trilinear"):
            np.testing.assert_allclose(
                tvideo.load_hu_volume(nii, meta, (5, 4, 4), resample),
                jvideo.load_hu_volume(nii, meta, (5, 4, 4), resample),
                atol=1e-6)
    v = np.arange(5 * 4, dtype=np.float32).reshape(1, 5, 2, 2)
    for frames in (3, 5, 8):
        np.testing.assert_array_equal(tvideo.cast_num_frames(v, frames),
                                      jvideo.cast_num_frames(v, frames))
    for frames in (2, 3, 4):
        np.testing.assert_array_equal(tvideo.cast_num_frames_mod1(v, frames),
                                      jvideo.cast_num_frames_mod1(v, frames))


def _tree(tmp_path):
    """Two accessions with metadata sidecars, a low-res tree, a report csv
    (one accession numeric, one missing impression) and its xlsx twin."""
    rng = np.random.default_rng(4)
    scans = []
    for acc, meta in (("ACC1", {"RescaleSlope": 1, "RescaleIntercept": 0,
                                "PatientAge": "063Y", "PatientSex": "F",
                                "Manufacturer": "PNMS"}),
                      ("ACC2", {"PatientAge": "041Y", "PatientSex": "M"}),
                      ("ACC3", {})):
        d = tmp_path / "data" / f"p{acc}" / acc
        d.mkdir(parents=True)
        nii = str(d / "scan.nii.gz")
        _write_nifti(nii, rng.integers(-900, 900, (6, 6, 9)).astype(np.int16))
        with open(str(d / "scan_metadata.json"), "w") as f:
            json.dump(meta, f)
        lr = tmp_path / "lowres" / f"samples.{acc}"
        lr.mkdir(parents=True)
        tvideo.write_nifti(str(lr / "scan.nii.gz"), rng.uniform(
            -1, 1, (4, 4, 5)).astype(np.float32))
        scans.append(nii)
    rows = [("AccessionNo", "Impressions"), ("ACC1", "Mild (edema)."),
            ("ACC2", "")]
    with open(tmp_path / "reports.csv", "w") as f:
        f.write("\n".join(",".join(r) for r in rows) + "\n")
    _xlsx(tmp_path / "reports.xlsx", [rows[0], rows[1], ("ACC2", "nan")],
          inline_row=0)
    return scans


def _same_items(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i in range(len(theirs)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_allclose(a[k], b[k], atol=1e-6)
            else:
                assert a[k] == b[k], k


def test_video_data_sets_match_jax(tmp_path):
    scans = _tree(tmp_path)
    data, csv = str(tmp_path / "data"), str(tmp_path / "reports.csv")
    kw = dict(target=(7, 8, 8), num_frames=2, min_slices=5)
    _same_items(tvideo.VideoTextDataset(data, csv, **kw),
                jvideo.VideoTextDataset(data, csv, **kw))
    assert tvideo.VideoTextDataset(data, csv, **kw)[1]["text"] == (
        "41 years old male: nan")
    _same_items(tvideo.VideoDataset(data, target=(7, 8, 8), num_frames=2),
                jvideo.VideoDataset(data, target=(7, 8, 8), num_frames=2))
    lowres = str(tmp_path / "lowres")
    _same_items(tvideo.VideoTextSuperresDataset(data, csv, lowres, **kw),
                jvideo.VideoTextSuperresDataset(data, csv, lowres, **kw))
    lst = tmp_path / "val.txt"
    lst.write_text(scans[1] + "\n")
    assert len(tvideo.VideoTextSuperresDataset(
        data, csv, lowres, sample_list=str(lst), **kw)) == 1
    # the default slice gate (100..600) drops the 9-slice scans
    assert len(tvideo.VideoTextDataset(data, csv)) == 0
    # the xlsx table joins as its csv twin (a text "nan" as pandas' NaN)
    xlsx = tvideo.VideoTextDataset(data, str(tmp_path / "reports.xlsx"), **kw)
    assert [s[1] for s in xlsx.samples] == [
        s[1] for s in tvideo.VideoTextDataset(data, csv, **kw).samples]
    # numeric accessions key as pandas keys them: ints, which no folder
    # name matches
    with open(tmp_path / "numeric.csv", "w") as f:
        f.write("AccessionNo,Impressions\n12,a\n7,b\n")
    assert tvideo.read_report_table(str(tmp_path / "numeric.csv")) == {
        12: "a", 7: "b"}
    gif = str(tmp_path / "v.gif")
    pytest.importorskip("PIL")
    tvideo.video_to_gif(np.random.default_rng(0).uniform(
        -1, 1, (3, 8, 8)), gif)
    assert open(gif, "rb").read(6) in (b"GIF89a", b"GIF87a")


def test_bpe_tokenizers_match_jax(tmp_path):
    merges = "#version: test\nl o\nlo w</w>\ne r</w>\nh e\nhe l\n"
    (tmp_path / "merges.txt").write_text(merges)
    texts = ["low lower hello", "covid19!! it's the lowest", "low " * 40]
    ours = tbpe.BPETokenizer(str(tmp_path / "merges.txt"), max_length=16)
    theirs = jbpe.BPETokenizer(str(tmp_path / "merges.txt"), max_length=16)
    for k, v in theirs(texts).items():
        np.testing.assert_array_equal(ours(texts)[k], v)
    pytest.importorskip("regex")
    vocab = {t: i for i, t in enumerate(
        ["<s>", "<pad>", "</s>", "<unk>", "l", "o", "w", "lo", "low", "Ġ",
         "Ġl", "Ġlow", "e", "r", "er", "!", "1", "9"])}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "bl_merges.txt").write_text(
        "#version: 0.2\nl o\nlo w\nĠ l\nĠl ow\ne r\n")
    args = (str(tmp_path / "vocab.json"), str(tmp_path / "bl_merges.txt"))
    ours, theirs = (tbpe.ByteLevelBPETokenizer(*args, max_length=12),
                    jbpe.ByteLevelBPETokenizer(*args, max_length=12))
    for k, v in theirs(texts).items():
        np.testing.assert_array_equal(ours(texts)[k], v)
