"""Batched BBCGGI19 FLP: prove / query / decide over whole report
batches (port of `mastic_tpu/flp/flp_jax.py`), for the five circuits
of `flp/circuits.py`.

Every circuit has one degree-2 gadget, so the gadget polynomial has
2p - 1 coefficients for the wire domain size p = next_pow2(calls + 1),
and its evaluations at the call points are the even entries of one
size-2p NTT.  Wire values at the call points are affine-bilinear in
the measurement and the joint-rand powers: one gather and one
elementwise product, no per-call loop.  All arithmetic runs in the
Montgomery limb domain (ops/field.py); plain limbs cross the call
boundary.
"""

from typing import Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.field import FieldSpec, field_sum, spec_for
from ..ops.ntt import ntt_plan, poly_eval_mont, pow_static, power_chain
from ..scalar.common import next_power_of_2
from .circuits import Histogram, MultihotCountVec, Sum


class BatchedFlp:
    """Batched prove/query/decide for one FLP instantiation."""

    def __init__(self, valid):
        self.valid = valid
        self.spec: FieldSpec = spec_for(valid.field)
        self.calls = valid.GADGET_CALLS
        self.arity = valid.GADGET_ARITY
        self.p = next_power_of_2(self.calls + 1)
        self.coeff_len = 2 * (self.p - 1) + 1
        self.meas_len = valid.MEAS_LEN
        self.eval_output_len = valid.EVAL_OUTPUT_LEN
        self.kind = valid.GADGET

        # Extra (non-gadget) output rows: coefficients over meas plus a
        # constant that scales with shares_inv.
        if isinstance(valid, Sum):
            # range_check = offset*shares_inv + decode(meas[:b])
            #             - decode(meas[b:])
            bits = valid.bits
            lin = [1 << i for i in range(bits)] + \
                [-(1 << i) for i in range(bits)]
            extra = [(lin, valid.offset)]
        elif isinstance(valid, Histogram):
            extra = [([1] * self.meas_len, -1)]
        elif isinstance(valid, MultihotCountVec):
            lin = [1] * valid.length + \
                [-(1 << i) for i in range(valid.bits_for_weight)]
            extra = [(lin, valid.offset)]
        else:  # Count, SumVec
            extra = []
        self.extra_lin = [row for (row, _) in extra]
        self.extra_const = [c for (_, c) in extra]

        self.intt_p = ntt_plan(self.spec, self.p, inverse=True)
        self.ntt_2p = ntt_plan(self.spec, 2 * self.p, inverse=False)
        self.intt_2p = ntt_plan(self.spec, 2 * self.p, inverse=True)

        if self.kind == "parallel_mul":
            # meas gather map: chunk k position j -> meas[k*c+j] or the
            # zero sentinel (index meas_len).
            c = valid.chunk_length
            self.chunk_length = c
            idx = np.full((self.calls, c), self.meas_len, np.int64)
            for k in range(self.calls):
                for j in range(c):
                    if k * c + j < self.meas_len:
                        idx[k, j] = k * c + j
            self.chunk_idx = idx

    # -- host-side Montgomery constants ----------------------------

    def _mont_const(self, value: int) -> np.ndarray:
        return self.spec.to_mont_host(value % self.spec.modulus)

    def _shares_inv(self, num_shares: int) -> int:
        return pow(num_shares, self.spec.modulus - 2, self.spec.modulus)

    # -- wire values at the call points ----------------------------

    def _wires(self, meas: torch.Tensor, joint_rand: Optional[torch.Tensor],
               num_shares: int) -> torch.Tensor:
        """Wire values for calls 1..C as (..., arity, p, n) Montgomery
        limbs with slots 0 and C+1.. zero (the caller installs the wire
        seeds at slot 0)."""
        spec = self.spec
        batch = meas.shape[:-2]
        n = spec.num_limbs
        wires = meas.new_zeros(batch + (self.arity, self.p, n))
        if self.kind == "mul":
            wires[..., 0, 1, :] = meas[..., 0, :]
            wires[..., 1, 1, :] = meas[..., 0, :]
            return wires
        if self.kind == "polyeval":
            wires[..., 0, 1:self.calls + 1, :] = meas
            return wires
        # parallel_mul: wire 2j at call k+1 = r_k^(j+1) * meas[k*c+j],
        #               wire 2j+1           = meas[k*c+j] - shares_inv
        if joint_rand is None:
            raise ValueError("this circuit needs joint randomness")
        c = self.chunk_length
        meas_ext = torch.cat([meas, meas.new_zeros(batch + (1, n))], dim=-2)
        idx = self.chunk_idx
        gathered = meas_ext[..., kernels.const_array(
            idx.tobytes(), idx.dtype.str, idx.shape, meas.device), :]
        r_pow = power_chain(spec, joint_rand, c)       # (..., C, c, n)
        even = spec.mul(r_pow, gathered)
        shares_inv = self._mont_const(self._shares_inv(num_shares))
        odd = spec.sub(gathered, shares_inv)
        pair = torch.stack([even, odd], dim=-2)        # (..., C, c, 2, n)
        vals = torch.movedim(pair, -4, -2)             # (..., c, 2, C, n)
        vals = vals.reshape(batch + (self.arity, self.calls, n))
        wires[..., 1:self.calls + 1, :] = vals
        return wires

    # -- circuit outputs -------------------------------------------

    def _extra_outputs(self, meas: torch.Tensor,
                       num_shares: int) -> Optional[torch.Tensor]:
        """The non-gadget output rows: (..., num_extra, n) Montgomery."""
        if not self.extra_const:
            return None
        spec = self.spec
        shares_inv = self._shares_inv(num_shares)
        rows = []
        for (lin, const) in zip(self.extra_lin, self.extra_const):
            coeffs = np.stack([self._mont_const(int(v)) for v in lin])
            acc = field_sum(spec, spec.mul(meas, coeffs), axis=-2)
            rows.append(spec.add(acc, self._mont_const(const * shares_inv)))
        return torch.stack(rows, dim=-2)

    def _circuit_value(self, gouts: torch.Tensor, meas: torch.Tensor,
                       weights: Optional[torch.Tensor],
                       num_shares: int) -> torch.Tensor:
        """Reduce gadget outputs + extra rows to the single circuit
        value v (random linear combination when EVAL_OUTPUT_LEN > 1)."""
        spec = self.spec
        extra = self._extra_outputs(meas, num_shares)
        if self.kind == "mul":
            return spec.sub(gouts[..., 0, :], meas[..., 0, :])
        if self.kind == "polyeval":
            outs = torch.cat([gouts, extra], dim=-2)
        elif extra is None:   # SumVec
            return field_sum(spec, gouts, axis=-2)
        else:                 # Histogram / MultihotCountVec
            outs = torch.cat(
                [field_sum(spec, gouts, axis=-2)[..., None, :], extra],
                dim=-2)
        return field_sum(spec, spec.mul(weights, outs), axis=-2)

    # -- gadget evaluation on the call domain ----------------------

    def _gadget_outputs(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Gadget polynomial (coeffs (..., 2p-1, n)) at alpha^1..alpha^C:
        the even indices of the size-2p NTT."""
        padded = torch.cat([
            coeffs,
            coeffs.new_zeros(coeffs.shape[:-2] +
                             (2 * self.p - self.coeff_len, coeffs.shape[-1]))
        ], dim=-2)
        evals = self.ntt_2p(padded)
        return evals[..., 2:2 * self.calls + 1:2, :]

    def _gadget_eval(self, x: torch.Tensor) -> torch.Tensor:
        """The bare gadget on Montgomery inputs x (..., arity, n)."""
        spec = self.spec
        if self.kind == "mul":
            return spec.mul(x[..., 0, :], x[..., 1, :])
        if self.kind == "polyeval":
            # p(z) = z^2 - z
            z = x[..., 0, :]
            return spec.sub(spec.mul(z, z), z)
        prod = spec.mul(x[..., 0::2, :], x[..., 1::2, :])
        return field_sum(spec, prod, axis=-2)

    # -- query / decide / prove ------------------------------------

    def _joint_rand_mont(self, joint_rand: Optional[torch.Tensor]):
        if joint_rand is None or not joint_rand.shape[-2]:
            return None
        return self.spec.to_mont(joint_rand)

    def query(self, meas: torch.Tensor, proof: torch.Tensor,
              query_rand: torch.Tensor, joint_rand: Optional[torch.Tensor],
              num_shares: int = 2) -> tuple:
        """Batched Flp.query over plain limbs: meas (..., MEAS_LEN, n),
        proof (..., PROOF_LEN, n), query_rand (..., QUERY_RAND_LEN, n),
        joint_rand (..., JOINT_RAND_LEN, n) or None.  Returns (verifier
        (..., VERIFIER_LEN, n) plain limbs, ok (...,): False where t
        landed inside the NTT domain)."""
        spec = self.spec
        meas = spec.to_mont(meas)
        proof = spec.to_mont(proof)
        query_rand = spec.to_mont(query_rand)
        jr = self._joint_rand_mont(joint_rand)
        if self.eval_output_len > 1:
            weights = query_rand[..., :self.eval_output_len, :]
            t = query_rand[..., self.eval_output_len, :]
        else:
            weights = None
            t = query_rand[..., 0, :]
        seeds = proof[..., :self.arity, :]
        coeffs = proof[..., self.arity:, :]
        wires = self._wires(meas, jr, num_shares)
        wires[..., 0, :] = seeds
        gouts = self._gadget_outputs(coeffs)
        v = self._circuit_value(gouts, meas, weights, num_shares)
        wire_at_t = poly_eval_mont(spec, self.intt_p(wires), t[..., None, :])
        gp_at_t = poly_eval_mont(spec, coeffs, t)
        verifier = torch.cat([v[..., None, :], wire_at_t,
                              gp_at_t[..., None, :]], dim=-2)
        one = kernels.const_array(spec.ONE_MONT.tobytes(),
                                  spec.ONE_MONT.dtype.str, spec.ONE_MONT.shape,
                                  t.device)
        ok = ~torch.all(pow_static(spec, t, self.p) == one, dim=-1)
        return (spec.from_mont(verifier), ok)

    def decide(self, verifier: torch.Tensor) -> torch.Tensor:
        """Batched Flp.decide over the summed verifier (plain limbs,
        (..., VERIFIER_LEN, n)) -> bool (...,)."""
        spec = self.spec
        v_zero = torch.all(verifier[..., 0, :] == 0, dim=-1)
        x = spec.to_mont(verifier[..., 1:1 + self.arity, :])
        y = spec.to_mont(verifier[..., 1 + self.arity, :])
        consistent = torch.all(self._gadget_eval(x) == y, dim=-1)
        return v_zero & consistent

    def prove(self, meas: torch.Tensor, prove_rand: torch.Tensor,
              joint_rand: Optional[torch.Tensor]) -> torch.Tensor:
        """Batched Flp.prove over plain limbs -> proof (..., PROOF_LEN,
        n)."""
        spec = self.spec
        meas_m = spec.to_mont(meas)
        seeds = spec.to_mont(prove_rand)
        wires = self._wires(meas_m, self._joint_rand_mont(joint_rand),
                            num_shares=1)
        wires[..., 0, :] = seeds
        wire_coeffs = self.intt_p(wires)              # (..., A, p, n)
        padded = torch.cat([wire_coeffs, torch.zeros_like(wire_coeffs)],
                           dim=-2)
        wire_evals = self.ntt_2p(padded)              # (..., A, 2p, n)
        gp_evals = self._gadget_eval(wire_evals.movedim(-3, -2))
        gp_coeffs = self.intt_2p(gp_evals)
        return torch.cat([spec.from_mont(seeds),
                          spec.from_mont(gp_coeffs[..., :self.coeff_len, :])],
                         dim=-2)
