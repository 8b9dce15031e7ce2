"""Intrinsic-dimension training: the Fastfood and dense subspace
reparameterization, and SAID (counterpart of
``peft_vit_tpu/peft/intrinsic.py``).

Reference: full_shot/main/intrinsic/fastfood.py (FastfoodWrap) and dense.py
(DenseWrap), driven by tools/intrinsic_dimension.py with ``--layerType
{attention,mlp,adapter} --layernum N`` (lib/models/
cls_intrinsic_dimension.py:782-783).  The math (fastfood_torched,
fastfood.py:151-187):

    theta = theta0 + Fastfood(V)[:DD],
    Fastfood(V) = H G Pi H (B V_pad) / (divisor * sqrt(DD / LL)),
    divisor = sqrt(LL * sum(G^2)),  LL = 2^ceil(log2 max(DD, d)),

H the unnormalized Walsh-Hadamard transform (``ops.wht``), B in {+-1}, Pi a
permutation, G ~ N(0, 1), all fixed; V in R^d (zeros at the start) is the
only trainable vector, shared by every wrapped tensor.  The dense form is
``theta = theta0 + P V`` with P ~ N(0, 1) / sqrt(d) of shape (DD, d).  SAID
(Aghajanyan et al. 2021) scales each tensor's ray by a trainable scalar.

The ray of a tensor is laid out over the JAX package's leaf in row-major
order: a Dense kernel is (in, out) there and the port's ``weight`` (out,
in), a conv kernel HWIO there and OIHW here.  So ``LeafProjection.shape`` is
the JAX leaf's shape, and ``materialize`` maps each ray the way
``models.convert`` maps that leaf, so that both packages perturb the same
elements.  The tensors are keyed by the port's parameter names, in the
order of the JAX package's sorted flat paths.

The draws (``build_projection``) come from an explicit ``torch.Generator``,
leaf by leaf in that order, on the generator's device;
``projection_from_jax`` carries a JAX projection across instead (the
counterpart of ``models.convert.params_from_jax``), so that both packages
compute the same theta.

The gradient through Pi is a gather by the inverse permutation
(``_Permute``), not the accumulating scatter of an indexing backward: no
gradient adds with atomics.  ``make_intrinsic_apply`` materializes theta in
every forward, so dL/dV flows through the transform.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import _torch_name_and_array, jax_path
from ..ops.wht import _ieee_fp32, wht

Tensors = Dict[str, torch.Tensor]


def _next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


class LeafProjection(NamedTuple):
    """The fixed Fastfood factors of one tensor."""

    b: torch.Tensor  # (LL,) +-1, fp32
    pi: torch.Tensor  # (LL,) int64, a permutation
    g: torch.Tensor  # (LL,) fp32, N(0, 1)
    divisor: torch.Tensor  # () fp32
    dd: int
    ll: int
    shape: Tuple[int, ...]  # the JAX leaf's shape: the ray's layout
    inv: torch.Tensor  # (LL,) int64, the inverse of ``pi``
    scale: torch.Tensor  # () fp32: divisor * sqrt(fp32(DD) / LL)


class IntrinsicProjection(NamedTuple):
    kind: str  # 'fastfood' | 'dense'
    dim: int
    theta0: Tensors  # port name -> fp32 initial value, in the port's layout
    leaves: Dict[str, Any]  # port name -> LeafProjection | dense (DD, d) fp32

    def to(self, device) -> "IntrinsicProjection":
        """The projection with every tensor on ``device``."""
        def move(leaf):
            if isinstance(leaf, LeafProjection):
                return leaf._replace(**{f: getattr(leaf, f).to(device)
                                        for f in ("b", "pi", "g", "divisor", "inv", "scale")})
            return leaf.to(device)

        return self._replace(theta0={k: v.to(device) for k, v in self.theta0.items()},
                             leaves={k: move(v) for k, v in self.leaves.items()})


def _jax_shape(name: str, shape) -> Tuple[int, ...]:
    """The JAX package's shape of the port's tensor ``name``: a Dense weight
    (out, in) is a kernel (in, out), a conv weight OIHW a kernel HWIO."""
    shape = tuple(int(s) for s in shape)
    if name.rsplit(".", 1)[-1] == "weight":
        if len(shape) == 2:
            return shape[::-1]
        if len(shape) == 4:
            return (shape[2], shape[3], shape[1], shape[0])
    return shape


def _port_layout(ray: torch.Tensor, name: str) -> torch.Tensor:
    """A ray in the JAX leaf's layout -> the port's tensor's layout (the map
    of ``models.convert.params_from_jax``)."""
    if name.rsplit(".", 1)[-1] == "weight":
        if ray.dim() == 2:
            return ray.t()
        if ray.dim() == 4:
            return ray.permute(3, 2, 0, 1)
    return ray


def _leaf(b, pi, g, divisor, dd: int, ll: int, shape) -> LeafProjection:
    pi = torch.as_tensor(pi, dtype=torch.int64)
    divisor = torch.as_tensor(divisor, dtype=torch.float32).reshape(())
    # in fp32 on the host, as the JAX package computes it
    scale = np.float32(divisor.item()) * np.sqrt(np.float32(dd) / np.float32(ll))
    return LeafProjection(
        b=torch.as_tensor(b, dtype=torch.float32), pi=pi,
        g=torch.as_tensor(g, dtype=torch.float32), divisor=divisor, dd=int(dd), ll=int(ll),
        shape=tuple(int(s) for s in shape), inv=torch.argsort(pi.cpu()).to(pi.device),
        scale=torch.tensor(np.float32(scale), dtype=torch.float32).to(pi.device))


def build_projection(generator: torch.Generator, target_params: Mapping[str, torch.Tensor],
                     intrinsic_dim: int, kind: str = "fastfood") -> IntrinsicProjection:
    """The projection of ``target_params`` (port name -> tensor, the values
    of theta0), drawn from ``generator`` on its device, a leaf at a time in
    the order of the JAX paths: b (``randint`` 0/1 -> +-1), pi
    (``randperm``), g (``randn``) and divisor = sqrt(LL sum(g^2)) for
    Fastfood; P = randn(DD, d) / sqrt(d) for the dense form."""
    if kind not in ("fastfood", "dense"):
        raise ValueError(f"unknown projection kind {kind!r}")
    device = generator.device
    order = sorted(target_params, key=lambda k: jax_path(k, target_params[k].dim()))
    theta0 = {k: target_params[k].detach().to(torch.float32).clone() for k in order}
    leaves: Dict[str, Any] = {}
    for k in order:
        shape = _jax_shape(k, theta0[k].shape)
        dd = int(np.prod(shape))
        if kind == "fastfood":
            ll = max(_next_pow2(dd), _next_pow2(intrinsic_dim))
            b = torch.randint(0, 2, (ll,), generator=generator, device=device)
            b = b.to(torch.float32) * 2.0 - 1.0
            pi = torch.randperm(ll, generator=generator, device=device)
            g = torch.randn(ll, generator=generator, device=device)
            divisor = torch.sqrt(ll * torch.sum(g ** 2))
            leaves[k] = _leaf(b, pi, g, divisor, dd, ll, shape)
        else:
            p = torch.randn(dd, intrinsic_dim, generator=generator, device=device)
            leaves[k] = p.div_(torch.sqrt(torch.full((), float(intrinsic_dim), device=device)))
    return IntrinsicProjection(kind, int(intrinsic_dim), theta0, leaves)


def projection_from_jax(proj) -> IntrinsicProjection:
    """A projection of the JAX package (its ``IntrinsicProjection``, or any
    object with ``kind``, ``dim``, ``theta0`` and ``leaves`` keyed by JAX
    path, arrays numpy or JAX) -> the port's: theta0 in the port's names and
    layouts, each ``LeafProjection`` keeping the JAX leaf's shape."""
    theta0: Tensors = {}
    leaves: Dict[str, Any] = {}
    for path in sorted(proj.theta0):
        name, arr = _torch_name_and_array(tuple(path.split("/")),
                                          np.array(proj.theta0[path], np.float32))
        theta0[name] = torch.from_numpy(np.ascontiguousarray(arr))
        leaf = proj.leaves[path]
        if proj.kind == "fastfood":
            leaves[name] = _leaf(np.array(leaf.b), np.array(leaf.pi), np.array(leaf.g),
                                 np.array(leaf.divisor), int(leaf.dd), int(leaf.ll),
                                 tuple(int(s) for s in leaf.shape))
        else:
            leaves[name] = torch.from_numpy(np.asarray(leaf, np.float32).copy())
    return IntrinsicProjection(str(proj.kind), int(proj.dim), theta0, leaves)


class _Permute(torch.autograd.Function):
    """x[pi] along the last axis; the gradient a gather by the inverse
    permutation."""

    @staticmethod
    def forward(ctx, x, pi, inv):
        ctx.save_for_backward(inv)
        return x.index_select(-1, pi)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(-1, inv), None, None


class _DenseRay(torch.autograd.Function):
    """P @ v and its gradient P^T @ g, both in IEEE fp32 (P is frozen)."""

    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p)
        with _ieee_fp32():
            return p @ v

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        with _ieee_fp32():
            return None, p.t() @ g


def fastfood_transform(v: torch.Tensor, leaf: LeafProjection) -> torch.Tensor:
    """H G Pi H (B v_pad) / (divisor sqrt(DD / LL)), cut to DD and shaped as
    the JAX leaf (fastfood_torched)."""
    vpad = F.pad(v.to(torch.float32), (0, leaf.ll - v.shape[0]))
    m2 = wht(leaf.b * vpad, normalize=False)
    m4 = _Permute.apply(m2, leaf.pi, leaf.inv) * leaf.g
    m5 = wht(m4, normalize=False)
    return (m5[: leaf.dd] / leaf.scale).reshape(leaf.shape)


def materialize(proj: IntrinsicProjection, v: torch.Tensor,
                said: Optional[Mapping[str, torch.Tensor]] = None) -> Tensors:
    """theta = theta0 + (lambda_i *) P_i(v), {port name: tensor in the port's
    layout}."""
    out = {}
    for k, theta0 in proj.theta0.items():
        leaf = proj.leaves[k]
        if proj.kind == "fastfood":
            ray = fastfood_transform(v, leaf)
        else:
            ray = _DenseRay.apply(leaf, v.to(torch.float32)).reshape(_jax_shape(k, theta0.shape))
        if said is not None:
            ray = ray * said[k]
        out[k] = theta0 + _port_layout(ray, k).to(theta0.dtype)
    return out


_LAYER_TYPES = {"attention": r"/attn/", "mlp": r"/mlp/", "adapter": r"/adapter/", "all": r""}


def select_intrinsic_targets(params: Mapping[str, torch.Tensor], layer_type: str = "all",
                             layer_num: int = -1) -> Dict[str, bool]:
    """The ``--layerType`` / ``--layernum`` selection as a mask over the port's
    parameter names, matched on their JAX paths as the JAX package matches
    (one block's attention / mlp / adapter, ``all`` the whole backbone; never
    the classifier)."""
    pat = _LAYER_TYPES[layer_type]
    mask = {}
    for k, t in params.items():
        path = jax_path(k, t.dim())
        ok = bool(re.search(pat, path)) if pat else True
        if layer_num >= 0:
            ok = ok and f"blocks_{layer_num}/" in path
        mask[k] = ok and not path.startswith("classifier/")
    return mask


def make_intrinsic_apply(apply_fn: Callable, proj: IntrinsicProjection, use_said: bool = False):
    """``(intrinsic_apply, trainable)`` for the engine (``engine.train``).

    ``trainable`` is ``{'v': zeros(d)}`` and, with ``use_said``, one scalar a
    wrapped tensor, ``said.<name>`` (ones).  ``intrinsic_apply(variables, x,
    train, **kw)`` materializes theta from the ``v`` (and ``said.*``) it is
    given and runs ``apply_fn`` (``engine.make_apply_fn``) with theta in place
    of the wrapped tensors and the rest of ``variables`` as they are.  The
    model's own tensors are the base; the frozen dict is empty."""

    def intrinsic_apply(variables, x, train, **kw):
        said = {k: variables[f"said.{k}"] for k in proj.theta0} if use_said else None
        theta = materialize(proj, variables["v"], said)
        rest = {k: t for k, t in variables.items() if k != "v" and not k.startswith("said.")}
        return apply_fn({**rest, **theta}, x, train, **kw)

    device = next(iter(proj.theta0.values())).device
    trainable: Tensors = {"v": torch.zeros(proj.dim, dtype=torch.float32, device=device)}
    if use_said:
        trainable.update({f"said.{k}": torch.ones((), dtype=torch.float32, device=device)
                          for k in proj.theta0})
    return intrinsic_apply, trainable
