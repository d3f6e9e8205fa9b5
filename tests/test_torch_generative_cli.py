"""The two generative CLIs of the port on the CPU:

- ``run_ctvit_recon --synthetic`` against the JAX package's ``main`` on the
  same weights (JAX's initial ones, through a reference .pt), the CTViT at
  the fp32 policy in both packages: 1e-4 absolute on the written volumes
  (values of order one);
- ``run_maskgit_sample`` (tiny random T5; skipped without transformers):
  one prompt and two chained scenes write a finite NIfTI of the right
  length, the same bits twice from one seed, and a MaskGIT checkpoint
  written by ``MaskGITTrainer.save`` is read back.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_exp_tpu.core.precision import FP32_POLICY as JAX_FP32
from vit_exp_tpu.models import ctvit as jctvit

from tests.test_torch_ctvit import _np
from vit_exp_tpu_torch.core.precision import FP32_POLICY
from vit_exp_tpu_torch.data.nifti import read_nifti
from vit_exp_tpu_torch.models import ctvit as tctvit
from vit_exp_tpu_torch.models.convert import from_jax_ctvit_variables


def test_run_ctvit_recon_synthetic_matches_jax_main(tmp_path, monkeypatch):
    """Both CLIs at their defaults but the width flags, with the CTViT
    built at the fp32 policy in both packages; the port reads the weights
    JAX's main initialises, through a reference .pt."""
    from vit_exp_tpu.cli import run_ctvit_recon as jcli
    from vit_exp_tpu_torch.cli import run_ctvit_recon as tcli

    monkeypatch.setattr(jctvit, "CTViT",
                        functools.partial(jctvit.CTViT, policy=JAX_FP32))
    monkeypatch.setattr(tctvit, "CTViT",
                        functools.partial(tctvit.CTViT, policy=FP32_POLICY))
    flags = ["--synthetic", "2", "--dim", "16", "--image_size", "8",
             "--patch_size", "4", "--num_frames", "5"]
    jcli.main(flags + ["--results_folder", str(tmp_path / "jax")])
    model = jctvit.CTViT(dim=16, image_size=8, patch_size=4,
                         temporal_patch_size=2, attn_impl="xla")
    variables = _np(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 5, 8, 8), jnp.float32),
        return_encoded_tokens=False, return_recons=True))
    ref_pt = tmp_path / "ctvit.pt"
    torch.save({"module." + k: torch.from_numpy(np.array(v))
                for k, v in from_jax_ctvit_variables(variables).items()},
               ref_pt)
    written = tcli.main(flags + ["--results_folder", str(tmp_path / "port"),
                                 "--checkpoint", str(ref_pt)], device="cpu")
    assert len(written) == 2
    for path in written:
        ours = read_nifti(path)
        theirs = read_nifti(path.replace(str(tmp_path / "port"),
                                         str(tmp_path / "jax")))
        assert ours.shape == (8, 8, 5)
        np.testing.assert_allclose(ours, theirs, atol=1e-4)


def test_run_maskgit_sample_writes_a_finite_volume(tmp_path):
    from vit_exp_tpu_torch.cli import run_maskgit_sample
    from vit_exp_tpu_torch.models import t5_adapter
    from vit_exp_tpu_torch.models.maskgit import MaskGit
    from vit_exp_tpu_torch.models.maskgit_pipeline import MaskGITTransformer
    from vit_exp_tpu_torch.train.ctvit_trainer import MaskGITTrainer

    if not t5_adapter.available():
        pytest.skip("transformers' T5EncoderModel is not installed")
    flags = ["--dim", "16", "--codebook_size", "32", "--image_size", "8",
             "--patch_size", "4", "--num_frames", "5", "--mg_dim", "16",
             "--mg_depth", "1", "--mg_heads", "2", "--mg_dim_head", "4",
             "--steps", "3", "--max_text_len", "8", "--prompt", "a chest CT"]

    def run(*extra, folder="one"):
        vol = run_maskgit_sample.main(
            flags + list(extra) + ["--results_folder", str(tmp_path / folder)],
            device="cpu")
        written = read_nifti(str(tmp_path / folder / "sample.nii.gz"))
        np.testing.assert_array_equal(written, vol.transpose(1, 2, 0))
        assert np.isfinite(vol).all()
        return vol

    one = run()
    assert one.shape == (5, 8, 8)
    np.testing.assert_array_equal(run(folder="again"), one)
    assert run("--prompt", "a second scene", folder="two").shape == (10, 8, 8)
    # a MaskGITTrainer checkpoint (the tiny T5's width, 12 tokens)
    mg = MaskGit(32, 12, 16, depth=1, heads=2, dim_head=4, dim_context=64,
                 device="cpu")
    with torch.no_grad():
        for p in mg.parameters():
            p.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(5))
    MaskGITTrainer(MaskGITTransformer(None, mg, None)).save(
        str(tmp_path / "mg"), step=7)
    loaded = run("--maskgit_checkpoint", str(tmp_path / "mg"), folder="ckpt")
    assert not np.array_equal(loaded, one)
