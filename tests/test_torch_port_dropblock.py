"""The port's DropBlock (``peft_vit_tpu_torch/ops/dropblock.py``) against the
JAX op (``peft_vit_tpu/ops/dropblock.py``) with the JAX op's own uniform draw
pinned: the min-pool branch (block < map) and the whole-map branch (block ==
map), the per-stage targets and the anneal, the gradient, the identity at
keep probability 1, the square-map error and the generator's draws.

Tolerances: the masked outputs and their gradients are equal bit for bit
(the same fp32 mask arithmetic: the comparison u < gamma on the same noise,
IEEE divisions, a 0/1 sum); the schedule's numbers too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peft_vit_tpu.ops import dropblock as jax_db
from peft_vit_tpu_torch.ops import dropblock as port_db


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _both(x_nhwc, block_size, keep_prob, seed=1):
    """The JAX op on the NHWC ``x`` with PRNGKey(seed), and the port's op on
    the NCHW transpose fed the JAX op's uniform draw."""
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jax_db.drop_block(jnp.asarray(x_nhwc), rng, block_size=block_size,
                                        keep_prob=keep_prob))
    u = np.asarray(jax.random.uniform(rng, x_nhwc.shape, jnp.float32))
    got = port_db.drop_block(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2),
                             block_size=block_size, keep_prob=keep_prob,
                             noise=torch.from_numpy(u).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("shape,block,keep", [
    ((2, 9, 9, 3), 3, 0.8),   # min-pool branch, odd block
    ((2, 14, 14, 4), 7, 0.9),  # the reference's block 7 on a 14 x 14 map
    ((3, 8, 8, 2), 4, 0.7),   # even block: the asymmetric (bs//2, (bs-1)//2) pad
    ((2, 7, 7, 5), 7, 0.9),   # block == map: one center decides the map
    ((2, 3, 3, 4), 7, 0.6),   # block > map: clipped to the map
])
def test_drop_block_matches_jax_under_its_noise(shape, block, keep):
    got, want = _both(_x(shape), block, keep)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()  # the draw dropped something


def test_keep_prob_one_is_the_identity():
    x = _x((2, 6, 6, 3))
    got = port_db.drop_block(torch.from_numpy(x).permute(0, 3, 1, 2), block_size=3,
                             keep_prob=1.0, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), x)


@pytest.mark.parametrize("keep", [0.9, 0.75])
def test_stage_targets_and_anneal_match_jax(keep):
    for stage in (1, 2, 3, 4):
        assert port_db.stage_keep_prob(keep, stage) == jax_db.stage_keep_prob(keep, stage)
    target = port_db.stage_keep_prob(keep, 3)
    for progress in (0.0, 0.125, 1.0 / 3.0, 0.5, 1.0, 1.5, -0.25):
        got = port_db.scheduled_keep_prob(target, torch.tensor(progress, dtype=torch.float32))
        want = np.asarray(jax_db.scheduled_keep_prob(target, jnp.float32(progress)))
        assert got.dtype == torch.float32 and float(got) == float(want)
        # a number in, the same fp32 number out (no tensor to copy to the card)
        assert port_db.scheduled_keep_prob(target, progress) == float(want)


def test_gradient_matches_jax():
    """The vjp through the mask and the renormalization, both branches."""
    for shape, block in (((2, 9, 9, 3), 3), ((2, 5, 5, 3), 5)):
        x = _x(shape, 2)
        rng = jax.random.PRNGKey(4)
        cot = _x(shape, 3)
        _, vjp = jax.vjp(lambda a: jax_db.drop_block(a, rng, block_size=block, keep_prob=0.7),
                         jnp.asarray(x))
        (want,) = vjp(jnp.asarray(cot))
        u = np.asarray(jax.random.uniform(rng, shape, jnp.float32))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        out = port_db.drop_block(xt, block_size=block, keep_prob=0.7,
                                 noise=torch.from_numpy(u).permute(0, 3, 1, 2))
        (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_square_maps_only_and_generator_draws():
    with pytest.raises(ValueError, match="H == W"):
        port_db.drop_block(torch.zeros(1, 2, 4, 5), block_size=3, keep_prob=0.9)
    x = torch.from_numpy(_x((2, 3, 8, 8)))
    a = port_db.drop_block(x, block_size=3, keep_prob=0.5,
                           generator=torch.Generator().manual_seed(7))
    b = port_db.drop_block(x, block_size=3, keep_prob=0.5,
                           generator=torch.Generator().manual_seed(7))
    c = port_db.drop_block(x, block_size=3, keep_prob=0.5,
                           generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the drawn noise is the noise argument's: the same mask when given explicitly
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, port_db.drop_block(x, block_size=3, keep_prob=0.5, noise=u))
