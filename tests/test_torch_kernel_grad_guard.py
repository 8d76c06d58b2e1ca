"""K1-K3's wrappers refuse a gradient (`ops/kernels/build.refuse_grad`).

No kernel has a backward, so under grad mode an operand that requires grad
raises, on a CPU tensor (the plain route) as on a CUDA one, rather than
return an output with no `grad_fn`; `jax.grad` through the JAX package's
Pallas kernel raises as well (shown for K3, in interpret mode). Under
`no_grad` and `inference_mode` the same call runs and equals the plain
version exactly; the plain versions stay differentiable.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.ops.pallas import adapter_bottleneck as JK3
from dg_sct_tpu_torch.ops.kernels import adapter_bottleneck as PK3
from dg_sct_tpu_torch.ops.kernels import block_attention as PK2
from dg_sct_tpu_torch.ops.kernels import window_attention as PK1


def _k1_args(rs):
    nW, N, H, D = 2, 16, 2, 8
    a = lambda *s, sc=1.0: torch.from_numpy((sc * rs.randn(*s)).astype(np.float32))
    mask = torch.from_numpy(np.where(rs.rand(nW, N, N) > 0.7, -100.0, 0.0).astype(np.float32))
    return ([a(2 * nW, N, H, D, sc=0.3), a(2 * nW, N, H, D, sc=0.3), a(2 * nW, N, H, D),
             a(H, N, N, sc=0.3), mask], {"nW": nW})


def _k2_args(rs):
    B, H, W, C, heads, ws, N = 1, 8, 8, 16, 2, 4, 16
    a = lambda *s, sc=1.0: torch.from_numpy((sc * rs.randn(*s)).astype(np.float32))
    args = [a(B, H, W, C), a(C, 3 * C, sc=0.2), a(3 * C, sc=0.1), a(C, C, sc=0.2), a(C, sc=0.1),
            a(heads, N, N, sc=0.3), 1.0 + a(C, sc=0.1), a(C, sc=0.1), None,
            math.log(10.0) + a(heads, sc=0.3)]
    return args, {"kind": "v2", "heads": heads, "ws": ws}


def _k3_args(rs):
    rows, C, g, go = 24, 64, 2, 8
    a = lambda *s, sc=1.0: torch.from_numpy((sc * rs.randn(*s)).astype(np.float32))
    return ([a(rows, C), a(g, C // g, go, sc=0.2), a(g * go, sc=0.1), a(g, go, C // g, sc=0.2),
             a(C, sc=0.1), 1.0 + a(C, sc=0.1), a(C, sc=0.1), 1.0 + a(C, sc=0.1), a(C, sc=0.1)],
            {"has_ln1": True})


KERNELS = {
    "K1": (PK1.window_attention, PK1.window_attention_plain, _k1_args),
    "K2": (PK2.fused_attn_half_block, PK2.fused_attn_half_block_plain, _k2_args),
    "K3": (PK3.bottleneck_rows, PK3.bottleneck_rows_plain, _k3_args),
}


@pytest.mark.parametrize("operand", ["input", "weight"])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_wrapper_refuses_a_gradient(name, operand):
    wrapper, plain, make = KERNELS[name]
    args, kw = make(np.random.RandomState(0))
    i = 0 if operand == "input" else 1        # x / q, then a weight (k for K1)
    args[i].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(*args, **kw)
    ref = plain(*args, **kw)
    assert ref.grad_fn is not None           # the plain version stays differentiable
    ref.square().sum().backward()
    assert args[i].grad is not None and torch.isfinite(args[i].grad).all()
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            got = wrapper(*args, **kw)
        assert got.grad_fn is None
        torch.testing.assert_close(got, ref.detach(), rtol=0, atol=0)


def test_wrapper_takes_operands_that_need_no_grad_under_grad_mode():
    for wrapper, plain, make in KERNELS.values():
        args, kw = make(np.random.RandomState(1))
        assert torch.is_grad_enabled()
        torch.testing.assert_close(wrapper(*args, **kw), plain(*args, **kw), rtol=0, atol=0)


def test_jax_refuses_a_gradient_through_its_k3():
    """The JAX package's counterpart: `jax.grad` through the K3 Pallas kernel
    (interpret mode on the CPU) raises; its forward runs."""
    args, kw = _k3_args(np.random.RandomState(2))
    x, *rest = (jnp.asarray(t.numpy()) for t in args)

    def f(x):
        return JK3._bottleneck_rows(x, *rest, has_ln1=kw["has_ln1"], row_tile=x.shape[0],
                                    interpret=True).sum()

    assert np.isfinite(float(f(x)))
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(f)(x)
