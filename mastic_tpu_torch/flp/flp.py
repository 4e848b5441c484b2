"""Batched BBCGGI19 FLP: prove / query / decide over whole report
batches (port of `mastic_tpu/flp/flp_jax.py`), for the Count circuit.

Count has one Mul gadget called once, so the gadget polynomial has
2p - 1 coefficients for the wire domain size p = next_pow2(calls + 1)
= 2, and its evaluation at the call point is an even entry of one
size-2p NTT.  All arithmetic runs in the Montgomery limb domain
(ops/field.py); plain limbs cross the call boundary.  Any other circuit
raises NotImplementedError.
"""

from typing import Optional

import torch

from ..common import next_power_of_2
from ..ops.field import FIELD64, FieldSpec
from ..ops.ntt import ntt_plan, poly_eval_mont, pow_static
from .circuits import Count


class BatchedFlp:
    """Batched prove/query/decide for one FLP instantiation."""

    def __init__(self, valid):
        if not isinstance(valid, Count):
            raise NotImplementedError(
                f"circuit {type(valid).__name__} is not ported yet")
        self.valid = valid
        self.spec: FieldSpec = FIELD64
        self.calls = valid.GADGET_CALLS
        self.arity = valid.GADGET_ARITY
        self.p = next_power_of_2(self.calls + 1)
        self.coeff_len = 2 * (self.p - 1) + 1
        self.intt_p = ntt_plan(self.spec, self.p, inverse=True)
        self.ntt_2p = ntt_plan(self.spec, 2 * self.p, inverse=False)
        self.intt_2p = ntt_plan(self.spec, 2 * self.p, inverse=True)

    def _wires(self, meas: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
        """Wire values (..., arity, p, n) Montgomery: the wire seeds at
        slot 0, the Mul call's inputs (meas, meas) at slot 1."""
        wires = meas.new_zeros(meas.shape[:-2] + (self.arity, self.p,
                                                   meas.shape[-1]))
        wires[..., :, 0, :] = seeds
        wires[..., 0, 1, :] = meas[..., 0, :]
        wires[..., 1, 1, :] = meas[..., 0, :]
        return wires

    def _gadget_outputs(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Gadget polynomial (coeffs (..., 2p-1, n)) at alpha^1..alpha^C:
        the even indices of the size-2p NTT."""
        padded = torch.cat([
            coeffs,
            coeffs.new_zeros(coeffs.shape[:-2] +
                             (2 * self.p - self.coeff_len, coeffs.shape[-1]))
        ], dim=-2)
        evals = self.ntt_2p(padded)
        return evals[..., [2 * k for k in range(1, self.calls + 1)], :]

    def query(self, meas: torch.Tensor, proof: torch.Tensor,
              query_rand: torch.Tensor, joint_rand: Optional[torch.Tensor],
              num_shares: int = 2) -> tuple:
        """Batched Flp.query over plain limbs: meas (..., 1, n), proof
        (..., 5, n), query_rand (..., 1, n).  Returns (verifier (..., 4,
        n) plain limbs, ok (...,): False where t landed inside the NTT
        domain)."""
        spec = self.spec
        meas = spec.to_mont(meas)
        proof = spec.to_mont(proof)
        t = spec.to_mont(query_rand)[..., 0, :]
        seeds = proof[..., :self.arity, :]
        coeffs = proof[..., self.arity:, :]
        wires = self._wires(meas, seeds)
        gouts = self._gadget_outputs(coeffs)
        v = spec.sub(gouts[..., 0, :], meas[..., 0, :])
        wire_at_t = poly_eval_mont(spec, self.intt_p(wires), t[..., None, :])
        gp_at_t = poly_eval_mont(spec, coeffs, t)
        verifier = torch.cat([v[..., None, :], wire_at_t,
                              gp_at_t[..., None, :]], dim=-2)
        one = torch.as_tensor(spec.ONE_MONT, device=t.device)
        ok = ~torch.all(pow_static(spec, t, self.p) == one, dim=-1)
        return (spec.from_mont(verifier), ok)

    def decide(self, verifier: torch.Tensor) -> torch.Tensor:
        """Batched Flp.decide over the summed verifier (plain limbs,
        (..., 4, n)) -> bool (...,)."""
        spec = self.spec
        v_zero = torch.all(verifier[..., 0, :] == 0, dim=-1)
        x = spec.to_mont(verifier[..., 1:1 + self.arity, :])
        y = spec.to_mont(verifier[..., 1 + self.arity, :])
        consistent = torch.all(
            spec.mul(x[..., 0, :], x[..., 1, :]) == y, dim=-1)
        return v_zero & consistent

    def prove(self, meas: torch.Tensor, prove_rand: torch.Tensor,
              joint_rand: Optional[torch.Tensor]) -> torch.Tensor:
        """Batched Flp.prove over plain limbs -> proof (..., 5, n)."""
        spec = self.spec
        meas_m = spec.to_mont(meas)
        seeds = spec.to_mont(prove_rand)
        wire_coeffs = self.intt_p(self._wires(meas_m, seeds))
        padded = torch.cat([wire_coeffs, torch.zeros_like(wire_coeffs)],
                           dim=-2)
        wire_evals = self.ntt_2p(padded)              # (..., A, 2p, n)
        gp_evals = spec.mul(wire_evals[..., 0, :, :],
                            wire_evals[..., 1, :, :])
        gp_coeffs = self.intt_2p(gp_evals)
        return torch.cat([spec.from_mont(seeds),
                          spec.from_mont(gp_coeffs[..., :self.coeff_len, :])],
                         dim=-2)
