#!/usr/bin/env python
"""The int8 serving accuracy gate on the PyTorch port (counterpart of
scripts/int8_accuracy_gate.py): the int8 zero-shot engine against the bf16
engine on the same seeded random weights at the flagship arch (batch 4, 36
prompts of 512 tokens) over N volumes of each base noise (--bases; the
serving volumes' draw by default, as the JAX script runs one) plus a
separable low-frequency field.  Prints, per base,
the probability spread, max and mean |Δprob| and the min and mean of the
per-label rank AUROC and Kendall τ, and exits 1 unless on every base max
|Δprob| ≤ --max_prob_delta and the min rank AUROC ≥ --min_rank_auroc.
--witnesses also reads the int8 and bf16 engines on their plain twins
against the same reference.  The implementation is
vit_exp_tpu_torch/eval/int8_gate.py.

    python scripts/int8_accuracy_gate_torch.py [--volumes 200] [--witnesses]
    python scripts/int8_accuracy_gate_torch.py --bases 1 2 3 4
    python scripts/int8_accuracy_gate_torch.py --device cpu --volumes 8

On the card by default (through the kernels); ``--device cpu`` runs the JAX
script's CPU arch on the plain route.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vit_exp_tpu_torch.eval.int8_gate import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
