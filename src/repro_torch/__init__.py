"""PyTorch/CUDA port of the MARINA-P reproduction (arXiv:2412.17082).

Mirrors the module layout of the JAX package ``repro`` (``repro_torch.core.marina_p``
answers to ``repro.core.marina_p``) and imports neither JAX nor ``repro``.
Entry points default to ``device="cuda"`` and raise where no card is present;
tests pass ``device="cpu"``. On a CUDA tensor the kernel wrappers in
``repro_torch.kernels.ops`` launch the hand-written Hopper kernels in
``csrc/``; on a CPU tensor they run the plain PyTorch versions.

Precision is fp32 throughout. The JAX reference runs its matrix products at
``jax_default_matmul_precision="highest"``, so TF32 is switched off here for
both cuBLAS and cuDNN when this package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
