"""PyTorch/CUDA port of drake_ddp_tpu: batched contact-implicit iLQR/MPC
on an NVIDIA Hopper card.

The package mirrors the JAX package's layout module for module
(``drake_ddp_tpu_torch/multibody/lanestep.py`` is the counterpart of
``drake_ddp_tpu/multibody/lanestep.py``) and is held to it by the
``tests/test_torch_*.py`` parity tests.  It imports torch and numpy only.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU with ``device="cpu"``; the CUDA kernels under ``csrc/`` are
built at first use into ``build/drake_ddp_tpu_torch/``.
"""

import torch

# Full float32 everywhere on the card.  TF32 keeps ~3 decimal digits, the
# H100 analogue of the TPU's default bf16 matmul passes that the JAX
# package pins off inside its Riccati sweep (solver/ilqr.py): stiff
# contact linearizations overflow or lose their descent directions at
# that precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from drake_ddp_tpu_torch._device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
