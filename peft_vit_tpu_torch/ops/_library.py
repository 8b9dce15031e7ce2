"""The kernels' launches as registered PyTorch ops.

Every launch of a hand-written kernel of ``csrc/`` goes through one op of
the namespace ``peft_vit_tpu_torch::`` (``torch.library.Library``), with

* a CUDA implementation: the wrapper's launcher (checks, ctypes call, the
  launch counted on the wrapper), unchanged;
* a CPU implementation: the kernel's plain PyTorch version;
* a fake implementation, shapes and dtypes only, which ``torch.export``,
  ``FakeTensorMode`` and the meta device run; it launches and counts
  nothing;
* a FLOP formula (``torch.utils.flop_counter``): the products the kernel
  computes, 2 m n k each, as the bounds in ``chip_smoke.py`` count them.

So an exported model names its kernels in its graph (a reloaded artifact
needs torch and this package's ``ops``, which registers the ops and builds
the kernels at first use), and ``FlopCounterMode`` counts what they compute.
Registering builds nothing: the CPU tests import every module.

The namespace is the package's top-level name, so that a second copy of
this package loaded under another name (``check_kernels_parent.py`` loads
an earlier tree's ``ops`` beside the current one) registers its own ops.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = __name__.split(".")[0]


# one library a namespace; it must live as long as the ops it defines
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def kernel_op(name: str, schema: str, *, cpu: Callable, cuda: Callable, fake: Callable,
              flops: Callable):
    """Define ``NAMESPACE::name`` with ``schema`` (its arguments and
    results in the dispatcher's syntax) and register its four
    implementations; returns the op (``torch.ops.<NAMESPACE>.<name>``).
    Another device raises in the dispatcher.  ``flops`` takes the tensors'
    shapes in the tensors' places.

    ``Library.define`` / ``impl`` puts each function straight on its
    dispatch key; ``torch.library.custom_op`` would wrap every call in its
    own Python layer (autograd registration, alias checks), host time on
    every launch, and the ops need none of it: the
    ``autograd.Function``s around them carry the gradients."""
    _LIBRARY.define(f"{name}{schema}")
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    return packet


def attention_products(shape, products: int) -> int:
    """``products`` (B H, N, D) x (B H, D, N) or (B H, N, N) x (B H, N, D)
    products of the (B, H, N, D) operands of ``shape``: 2 B H N^2 D each."""
    b, h, n, d = shape
    return 2 * products * b * h * n * n * d
