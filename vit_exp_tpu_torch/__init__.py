"""vit_exp_tpu_torch — the PyTorch / CUDA port of ``vit_exp_tpu`` for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``vit_exp_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find:

- ``core``    precision policy, experiment config (the YAML schema), the
              process group and the CLIs' multi-host flags, the process
              grid
- ``parallel`` the collectives of data and sequence parallelism
- ``ops``     position embedding, patch embedding, fused LN+qkv projection,
              fused GEGLU feed-forward, static-max and online-softmax
              cosine attention, ring attention; every Pallas kernel of the JAX package is a
              hand-written CUDA kernel here (sources in ``csrc/``, built by
              ``ops/_build.py``)
- ``models``  CTViT3D image tower, BERT text tower, CTCLIP, factory,
              losses, parameter mapping from the JAX package
- ``data``    tokenizers, synthetic and planted volumes, the threaded batch
              loader, the NIfTI reader, the CT-RATE npz data sets and the
              packed store
- ``native``  the packed store's C++ reader (g++, ctypes)
- ``train``   optimizer, train steps, dataset sampler, checkpoints, trainer
- ``utils``   metric logger, step timer
- ``cli``     ``run_train``, ``run_zero_shot_cls``, ``run_zero_shot_seg``,
              ``serve``, ``pack_dataset``, ``preprocess_ctrate``
- ``eval``    zero-shot engines, metrics, the checkpoint sweep, hooks

Importing the package imports neither CUDA kernels nor the JAX package:
kernels build on first launch, and only on a CUDA tensor.
"""

__version__ = "0.1.0"
