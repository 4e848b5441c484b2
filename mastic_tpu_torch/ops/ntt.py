"""Batched number-theoretic transforms over the 16-bit-limb Montgomery
representation (port of `mastic_tpu/ops/ntt_jax.py`).

The FLP only needs transforms of a small static power-of-two size p,
so each transform is an iterative radix-2 butterfly network with
host-precomputed Montgomery-domain twiddles."""

import numpy as np
import torch

from . import kernels
from .field import FieldSpec


def _bit_reverse_perm(size: int) -> np.ndarray:
    bits = size.bit_length() - 1
    out = np.zeros(size, np.int64)
    for i in range(size):
        out[i] = int(f"{i:0{bits}b}"[::-1], 2) if bits else 0
    return out


class NttPlan:
    """One transform: out[j] = sum_k x[k] omega^(jk), omega the
    canonical generator of the order-`size` subgroup (forward) or its
    inverse with the 1/size factor folded in (inverse)."""

    def __init__(self, spec: FieldSpec, size: int, inverse: bool):
        assert size & (size - 1) == 0 and size >= 1
        self.spec = spec
        self.size = size
        self.inverse = inverse
        mod = spec.modulus
        gen = pow(7, (mod - 1) // spec.gen_order, mod)
        omega = pow(gen, spec.gen_order // size, mod)
        if inverse:
            omega = pow(omega, mod - 2, mod)
        self.perm = _bit_reverse_perm(size)
        self.stage_twiddles = []
        m = 1
        while m < size:
            step = size // (2 * m)
            self.stage_twiddles.append(np.stack([
                spec.to_mont_host(pow(omega, j * step, mod))
                for j in range(m)]))
            m *= 2
        self.size_inv = spec.to_mont_host(
            pow(size, mod - 2, mod)) if inverse else None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Transform (..., size, n) Montgomery limbs along axis -2."""
        spec = self.spec
        assert x.shape[-2] == self.size
        # The permutation is uploaded once per device (kernels.const_array):
        # a copy from pageable memory each call would wait for the stream.
        perm = self.perm
        x = x[..., kernels.const_array(perm.tobytes(), perm.dtype.str,
                                       perm.shape, x.device), :]
        m = 1
        for tw in self.stage_twiddles:
            x = x.reshape(x.shape[:-2] + (self.size // (2 * m), 2 * m,
                                          x.shape[-1]))
            even = x[..., :m, :]
            odd = spec.mul(x[..., m:, :], tw)
            x = torch.cat([spec.add(even, odd), spec.sub(even, odd)],
                          dim=-2)
            x = x.reshape(x.shape[:-3] + (-1, x.shape[-1]))
            m *= 2
        if self.size_inv is not None:
            x = spec.mul(x, self.size_inv)
        return x


_PLANS: dict = {}


def ntt_plan(spec: FieldSpec, size: int, inverse: bool) -> NttPlan:
    key = (spec.modulus, size, inverse)
    plan = _PLANS.get(key)
    if plan is None:
        plan = NttPlan(spec, size, inverse)
        _PLANS[key] = plan
    return plan


def poly_eval_mont(spec: FieldSpec, coeffs: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Horner evaluation: coeffs (..., L, n) low-to-high Montgomery, t
    (..., n) Montgomery -> (..., n)."""
    length = coeffs.shape[-2]
    acc = coeffs[..., length - 1, :]
    t_b = t.expand(coeffs.shape[:-2] + t.shape[-1:])
    for k in range(length - 2, -1, -1):
        acc = spec.add(spec.mul(acc, t_b), coeffs[..., k, :])
    return acc


def pow_static(spec: FieldSpec, t: torch.Tensor,
               exponent: int) -> torch.Tensor:
    """t^exponent for a static exponent (square-and-multiply)."""
    assert exponent >= 1
    acc = None
    base = t
    e = exponent
    while e:
        if e & 1:
            acc = base if acc is None else spec.mul(acc, base)
        e >>= 1
        if e:
            base = spec.mul(base, base)
    return acc


def power_chain(spec: FieldSpec, t: torch.Tensor,
                count: int) -> torch.Tensor:
    """[t^1, t^2, ..., t^count] stacked on a new axis -2."""
    out = [t]
    for _ in range(count - 1):
        out.append(spec.mul(out[-1], t))
    return torch.stack(out, dim=-2)
