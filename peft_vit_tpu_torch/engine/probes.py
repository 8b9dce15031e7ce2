"""Logistic probes over frozen features (counterpart of
``peft_vit_tpu/engine/probes.py``).

* ``logistic_probe_vmapped``: multinomial logistic regression with the L2
  penalty 1/C, fitted for every C at once.  The JAX package fits it with
  ``optax.lbfgs`` under ``jax.vmap`` over C; here ``_lbfgs_logistic`` is a
  batched L-BFGS over the C axis (memory 10, a backtracking Armijo line
  search, float64) on the same objective, from the same zero init, for the
  same ``max_iter``.  Its iterates are not optax's (the line searches
  differ); the objective is strictly convex, so both reach its minimizer,
  and the tests hold the two to the objective there, the accuracies and
  the chosen C.
* ``logistic_probe_sweep``: the CLIP paper's protocol (the reference's
  evaluation/logistic_classifier.py:13-117): C over 97 logspace points,
  coarse 7 and a binary refinement, a final fit on train + val.
* The linear probe is the driver (``commands.run``, ``PEFT.METHOD``
  linear).  The sklearn paths (``use_sklearn``, ``multilabel_probe``) need
  sklearn and raise.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import resolve_device

logger = logging.getLogger(__name__)

LBFGS_MEMORY = 10
_ARMIJO = 1e-4
_HALVINGS = 60
_GRAD_TOL = 1e-12  # a fit whose gradient's largest entry is below this has converged


def logistic_objective(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       c_values: torch.Tensor) -> torch.Tensor:
    """The objective of every C at once (the JAX ``loss_fn``): the mean
    negative log-likelihood of ``softmax(x w + b)`` plus ``0.5 / C *
    sum(w^2) / n``.  x (n, d), y (n,), w (C, d, k), b (C, k) -> (C,)."""
    n = x.shape[0]
    logp = torch.log_softmax(torch.einsum("nd,cdk->cnk", x, w) + b[:, None, :], dim=-1)
    nll = -logp.gather(-1, y.reshape(1, n, 1).expand(len(c_values), n, 1))[..., 0].mean(-1)
    return nll + 0.5 / c_values * (w * w).sum(dim=(1, 2)) / n


def _lbfgs_logistic(x: torch.Tensor, y: torch.Tensor, c_values: torch.Tensor, num_classes: int,
                    max_iter: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w (C, d, k), b (C, k))`` minimizing ``logistic_objective`` for each
    C, by L-BFGS batched over C: every C keeps its own history of the last
    ``LBFGS_MEMORY`` steps and its own step length.  A pair whose curvature
    s.y is not positive is kept inert (rho 0); a C whose gradient is below
    ``_GRAD_TOL`` stops moving."""
    cs, d, k = len(c_values), x.shape[1], num_classes
    z = torch.zeros(cs, d * k + k, dtype=x.dtype, device=x.device)

    def value_grad(z):
        z = z.detach().requires_grad_()
        f = logistic_objective(x, y, z[:, : d * k].reshape(cs, d, k), z[:, d * k:], c_values)
        (g,) = torch.autograd.grad(f.sum(), z)
        return f.detach(), g

    def value(z):
        with torch.no_grad():
            return logistic_objective(x, y, z[:, : d * k].reshape(cs, d, k), z[:, d * k:],
                                      c_values)

    f, g = value_grad(z)
    hist = []  # (s, y, rho), oldest first
    for it in range(max_iter):
        q = g.clone()
        alphas = []
        for s_i, y_i, rho in reversed(hist):
            a = rho * (s_i * q).sum(-1)
            q -= a[:, None] * y_i
            alphas.append(a)
        if hist:
            s_i, y_i, rho = hist[-1]
            sy, yy = (s_i * y_i).sum(-1), (y_i * y_i).sum(-1)
            gamma = torch.where(rho > 0, sy / yy.clamp_min(1e-300), torch.ones_like(sy))
        else:  # the first step: -g scaled to unit length
            gamma = 1.0 / torch.linalg.vector_norm(g, dim=-1).clamp_min(1e-300)
        q *= gamma[:, None]
        for (s_i, y_i, rho), a in zip(hist, reversed(alphas)):
            bcoef = rho * (y_i * q).sum(-1)
            q += (a - bcoef)[:, None] * s_i
        direction = -q
        slope = (g * direction).sum(-1)
        bad = slope >= 0  # not a descent direction: fall back to steepest descent
        direction = torch.where(bad[:, None], -g, direction)
        slope = torch.where(bad, -(g * g).sum(-1), slope)
        live = g.abs().amax(-1) > _GRAD_TOL
        t = live.to(x.dtype)
        accepted = ~live
        for _ in range(_HALVINGS):
            trial = value(z + t[:, None] * direction)
            ok = trial <= f + _ARMIJO * t * slope
            accepted = accepted | ok
            if bool(accepted.all()):
                break
            t = torch.where(accepted, t, 0.5 * t)
        t = torch.where(accepted, t, torch.zeros_like(t))
        z_new = z + t[:, None] * direction
        f_new, g_new = value_grad(z_new)
        s_new, y_new = z_new - z, g_new - g
        sy = (s_new * y_new).sum(-1)
        rho = torch.where(sy > 0, 1.0 / sy.clamp_min(1e-300), torch.zeros_like(sy))
        hist = (hist + [(s_new, y_new, rho)])[-LBFGS_MEMORY:]
        z, f, g = z_new, f_new, g_new
    return z[:, : d * k].reshape(cs, d, k), z[:, d * k:]


def logistic_probe_vmapped(train_x: np.ndarray, train_y: np.ndarray, val_x: np.ndarray,
                           val_y: np.ndarray, num_classes: int, c_values: Sequence[float],
                           max_iter: int = 200, device=None) -> Tuple[float, np.ndarray]:
    """Fit every C of ``c_values`` at once on ``device`` (None: the card);
    returns ``(best C, the validation accuracies in percent)``, the first
    best on a tie."""
    device = resolve_device(device)
    as64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    cv = as64(list(c_values))
    w, b = _lbfgs_logistic(as64(train_x), torch.as_tensor(np.asarray(train_y), device=device)
                           .long(), cv, num_classes, max_iter)
    pred = (torch.einsum("nd,cdk->cnk", as64(val_x), w) + b[:, None, :]).argmax(-1)
    target = torch.as_tensor(np.asarray(val_y), device=device)
    # the count of hits on the device, the fraction on the host: the card's
    # mean multiplies by 1 / n, a last-bit other number than the division
    hits = (pred == target[None]).sum(-1).cpu().numpy()
    accs = hits / len(target) * 100.0
    return float(c_values[int(np.argmax(accs))]), accs


def logistic_probe_sweep(train_x, train_y, val_x, val_y, test_x, test_y, num_classes: int,
                         log_lower: float = -6.0, log_upper: float = 6.0, points: int = 97,
                         use_sklearn: bool = False, max_iter: int = 200,
                         device=None) -> Tuple[float, float]:
    """The CLIP paper's protocol: coarse 7 and a binary refinement over C in
    logspace, the final fit on train + val, the test accuracy.  Returns
    ``(test accuracy, best C)``."""
    if use_sklearn:
        raise NotImplementedError("the sklearn logistic probe needs sklearn, which "
                                  "peft_vit_tpu_torch does not use (ROADMAP §1, the rest)")
    grid = np.logspace(log_lower, log_upper, points)
    coarse = set(np.logspace(log_lower, log_upper, 7))
    scores = {}

    def probe(idxs):
        new = [i for i in idxs if i not in scores]
        if new:
            _, accs = logistic_probe_vmapped(train_x, train_y, val_x, val_y, num_classes,
                                             [grid[i] for i in new], max_iter, device)
            scores.update({i: float(a) for i, a in zip(new, accs)})

    probe([i for i, v in enumerate(grid) if v in coarse])
    peak = max(scores, key=scores.get)
    span = 8
    while span > 0:
        left, right = max(peak - span, 0), min(peak + span, len(grid) - 1)
        probe([i for i in (left, right) if i != peak])
        peak = max(scores, key=scores.get)
        span //= 2
    best_c = float(grid[peak])
    logger.info("=> logistic probe best C=%g", best_c)
    _, accs = logistic_probe_vmapped(np.concatenate([train_x, val_x]),
                                     np.concatenate([train_y, val_y]), test_x, test_y,
                                     num_classes, [best_c], max_iter, device)
    return float(accs[0]), best_c


def multilabel_probe(*args, **kwargs):
    """The one-vs-rest probe of the JAX package needs sklearn."""
    raise NotImplementedError("multilabel_probe needs sklearn, which peft_vit_tpu_torch does not "
                              "use (ROADMAP §1, the rest)")
