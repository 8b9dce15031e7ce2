"""Parameterized hypercomplex multiplication (PHM / Kronecker) ops
(counterpart of ``peft_vit_tpu/ops/phm.py``).

The math of the reference's Compacter and KAdaptation methods:
``H = sum_i rule_i (x) W_i`` with ``rule`` (n, n, n) and ``W`` (n, in/n,
out/n), then ``y = x @ H (+ b)``; KAdaptation factorizes
``W_i = W_left_i @ W_right_i`` with rank ``phm_rank``.

The dtype order is the JAX package's: the Kronecker product is taken in the
dtype of its operands (the caller casts them to the compute dtype first),
the product ``x @ H`` accumulates in fp32 and is rounded to ``x``'s dtype,
and a bias is added after that rounding.  This is plain PyTorch (the JAX
package runs it as XLA einsums, outside any Pallas kernel); under
``torch.func.vmap`` a batched rule or weight builds one ``H`` per cell.
"""

from __future__ import annotations

from typing import Optional

import torch


def kronecker_product_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product: a (n, p, q), b (n, r, s) -> (n, p*r, q*s)."""
    n, p, q = a.shape
    _, r, s = b.shape
    out = torch.einsum("npq,nrs->nprqs", a, b)
    return out.reshape(n, p * r, q * s)


def phm_weight(rule: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``H = sum_i rule_i (x) W_i``: rule (n, n, n), w (n, in/n, out/n) ->
    H (in, out)."""
    return kronecker_product_batched(rule, w).sum(0)


def phm_linear(x: torch.Tensor, rule: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ H (+ bias)`` with H the PHM-constructed weight; the product
    is rounded to ``x``'s dtype before the bias is added."""
    y = torch.matmul(x, phm_weight(rule, w).to(x.dtype))
    if bias is not None:
        y = y + bias
    return y


def factorized_phm_weight(rule: torch.Tensor, w_left: torch.Tensor,
                          w_right: torch.Tensor) -> torch.Tensor:
    """KAdaptation: ``H = sum_i rule_i (x) (W_left_i @ W_right_i)``: rule
    (n, n, n), w_left (n, in/n, r), w_right (n, r, out/n)."""
    return phm_weight(rule, torch.matmul(w_left, w_right))
