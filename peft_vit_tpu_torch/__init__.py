"""PyTorch/CUDA port of ``peft_vit_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference.  This package mirrors
its layout (``peft/``, ``ops/``, ``models/``, ``engine/``) so that each
module has a counterpart of the same name, and imports only ``torch`` and
``numpy``: nothing of JAX and nothing of ``peft_vit_tpu``.

Every Pallas kernel that the JAX package runs on a slice's path has a
hand-written CUDA C++ counterpart in ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use (``ops/_build.py``).  A kernel wrapper launches its
kernel for CUDA tensors and runs its plain PyTorch version for CPU tensors;
there is no other fallback.

Ported so far: the CLIP-style ViT LoRA classifier
(``models.factory.flagship``), served (``engine.serving.ServingSession``)
and trained (``peft.masks``, ``engine.train``; fp32 master weights under a
bf16 model), with the flash-attention forward kernel and its two backward
kernels behind ``ops.attention.flash_attention``; and the int8 frozen tower
(``ops.int8``, ``models.layers.Int8Dense``): int8 serving (``int8=True``) and
the int8 LoRA training recipes (``int8_train=True`` with a pre-quantized tree,
the int8 dx backward and static activation scales), with the quantize + int8
GEMM + rescale kernel behind ``ops.int8.int8_gemm_dynamic`` and
``int8_gemm_static``.
"""
