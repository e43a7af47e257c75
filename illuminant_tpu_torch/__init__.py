"""illuminant_tpu_torch: the PyTorch / CUDA port of illuminant_tpu.

The JAX package `illuminant_tpu` is the reference; this package computes the
same functions with PyTorch tensors and, where the JAX package had a Pallas
TPU kernel, a CUDA kernel written for Hopper (`csrc/`). The layout mirrors
the JAX package: the counterpart of `illuminant_tpu/x/y.py` is
`illuminant_tpu_torch/x/y.py`. Importing this package never imports jax.

Float32 matrix products and convolutions run in full float32 here: TF32 is
switched off for both cuBLAS and cuDNN when the package is imported, so a
result on the card is comparable with the float32 plain versions and with
the JAX reference on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
