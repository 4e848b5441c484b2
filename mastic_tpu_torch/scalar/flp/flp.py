"""Copy of `mastic_tpu/flp/flp.py`: the Fully Linear Proof system of
[BBCGGI19], as draft-irtf-cfrg-vdaf-13 §7.3 profiles it
(`FlpBBCGGI19`).

The prover evaluates the validity circuit while recording every
gadget's wire inputs; each wire becomes a polynomial interpolated over
a power-of-two NTT domain, and the proof carries the wire seeds plus
the composed gadget polynomial's coefficients.  The verifier
re-evaluates the circuit with the gadget polynomial in place of the
gadget and spot-checks wire/gadget consistency at a random point.
"""

from typing import Generic, TypeVar

from ..common import front, next_power_of_2
from ..field import F, poly_add, poly_eval, poly_interp, poly_mul

W = TypeVar("W")  # measurement type
R = TypeVar("R")  # aggregate result type


class Gadget(Generic[F]):
    """A non-linear subcircuit: low arity and degree, called many times."""

    ARITY: int
    DEGREE: int

    def eval(self, field: type[F], inp: list[F]) -> F:
        raise NotImplementedError()

    def eval_poly(self, field: type[F], inp_poly: list[list[F]]) \
            -> list[F]:
        """Evaluate over polynomial inputs (coefficient vectors)."""
        raise NotImplementedError()


class Mul(Gadget[F]):
    ARITY = 2
    DEGREE = 2

    def eval(self, field: type[F], inp: list[F]) -> F:
        return inp[0] * inp[1]

    def eval_poly(self, field: type[F], inp_poly: list[list[F]]) -> list[F]:
        return poly_mul(field, inp_poly[0], inp_poly[1])


class PolyEval(Gadget[F]):
    """Gadget evaluating a fixed univariate polynomial `p` (list of int
    coefficients, low-to-high)."""

    ARITY = 1

    def __init__(self, p: list[int]):
        assert len(p) >= 2
        self.p = p
        self.DEGREE = len(p) - 1

    def eval(self, field: type[F], inp: list[F]) -> F:
        return poly_eval(field, [field(c % field.MODULUS) for c in self.p],
                         inp[0])

    def eval_poly(self, field: type[F], inp_poly: list[list[F]]) -> list[F]:
        out = [field(self.p[-1] % field.MODULUS)]
        for coeff in reversed(self.p[:-1]):
            out = poly_mul(field, out, inp_poly[0])
            if not out:
                out = [field(0)]
            out[0] += field(coeff % field.MODULUS)
        return out


class ParallelSum(Gadget[F]):
    """Sum of `count` invocations of a subgadget on disjoint inputs."""

    def __init__(self, subcircuit: Gadget[F], count: int):
        self.subcircuit = subcircuit
        self.count = count
        self.ARITY = subcircuit.ARITY * count
        self.DEGREE = subcircuit.DEGREE

    def eval(self, field: type[F], inp: list[F]) -> F:
        out = field(0)
        for i in range(self.count):
            start = i * self.subcircuit.ARITY
            out += self.subcircuit.eval(
                field, inp[start:start + self.subcircuit.ARITY])
        return out

    def eval_poly(self, field: type[F], inp_poly: list[list[F]]) -> list[F]:
        out: list[F] = []
        for i in range(self.count):
            start = i * self.subcircuit.ARITY
            term = self.subcircuit.eval_poly(
                field, inp_poly[start:start + self.subcircuit.ARITY])
            out = poly_add(field, out, term)
        return out


class Valid(Generic[W, R, F]):
    """A validity circuit: an arithmetic circuit over gadgets plus the
    measurement encoding/truncation/decoding maps."""

    field: type[F]
    MEAS_LEN: int
    OUTPUT_LEN: int
    JOINT_RAND_LEN: int
    EVAL_OUTPUT_LEN: int
    GADGETS: list[Gadget[F]]
    GADGET_CALLS: list[int]

    def encode(self, measurement: W) -> list[F]:
        raise NotImplementedError()

    def truncate(self, meas: list[F]) -> list[F]:
        raise NotImplementedError()

    def decode(self, output: list[F], num_measurements: int) -> R:
        raise NotImplementedError()

    def eval(self, meas: list[F], joint_rand: list[F],
             num_shares: int) -> list[F]:
        """Evaluate the circuit; gadget calls go through self.GADGETS
        (which prove/query wrap to record or replace wire values)."""
        raise NotImplementedError()

    def check_valid_eval(self, meas: list[F], joint_rand: list[F]) -> None:
        assert len(meas) == self.MEAS_LEN
        assert len(joint_rand) == self.JOINT_RAND_LEN

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        return []


class _ProveGadget(Gadget[F]):
    """Wraps a gadget during proof generation: seeds each wire with a
    prove_rand element at domain point alpha^0 and records the inputs of
    call k at alpha^(k+1)."""

    def __init__(self, field: type[F], wire_seeds: list[F],
                 inner: Gadget[F], calls: int):
        self.inner = inner
        self.ARITY = inner.ARITY
        self.DEGREE = inner.DEGREE
        p = next_power_of_2(calls + 1)
        self.wires = [[field(0)] * p for _ in range(inner.ARITY)]
        for (j, seed) in enumerate(wire_seeds):
            self.wires[j][0] = seed
        self.k = 0

    def eval(self, field: type[F], inp: list[F]) -> F:
        self.k += 1
        for j in range(self.ARITY):
            self.wires[j][self.k] = inp[j]
        return self.inner.eval(field, inp)


class _QueryGadget(Gadget[F]):
    """Wraps a gadget during query: records wire inputs and returns the
    (prover-supplied) gadget polynomial evaluated at alpha^(k+1)."""

    def __init__(self, field: type[F], wire_seeds: list[F],
                 gadget_poly: list[F], inner: Gadget[F], calls: int):
        self.ARITY = inner.ARITY
        self.DEGREE = inner.DEGREE
        p = next_power_of_2(calls + 1)
        self.wires = [[field(0)] * p for _ in range(inner.ARITY)]
        for (j, seed) in enumerate(wire_seeds):
            self.wires[j][0] = seed
        # The gadget polynomial has degree DEGREE*(p-1) (larger than the
        # size-p wire domain), so it is evaluated pointwise at the call
        # points alpha^(k+1), lazily as calls arrive.
        self.gadget_poly = gadget_poly
        self.alpha = field.gen() ** (field.GEN_ORDER // p)
        self.k = 0

    def eval(self, field: type[F], inp: list[F]) -> F:
        self.k += 1
        for j in range(self.ARITY):
            self.wires[j][self.k] = inp[j]
        return poly_eval(field, self.gadget_poly, self.alpha ** self.k)


class FlpBBCGGI19(Generic[W, R, F]):
    """The [BBCGGI19] FLP for a given validity circuit."""

    def __init__(self, valid: Valid[W, R, F]):
        self.valid = valid
        self.field: type[F] = valid.field
        self.MEAS_LEN = valid.MEAS_LEN
        self.OUTPUT_LEN = valid.OUTPUT_LEN
        self.JOINT_RAND_LEN = valid.JOINT_RAND_LEN
        self.PROVE_RAND_LEN = sum(g.ARITY for g in valid.GADGETS)
        # One independent reduction weight per circuit output (when
        # there is more than one), plus one spot-check point per gadget.
        self.QUERY_RAND_LEN = len(valid.GADGETS)
        if valid.EVAL_OUTPUT_LEN > 1:
            self.QUERY_RAND_LEN += valid.EVAL_OUTPUT_LEN
        self.PROOF_LEN = 0
        for (g, calls) in zip(valid.GADGETS, valid.GADGET_CALLS):
            p = next_power_of_2(calls + 1)
            self.PROOF_LEN += g.ARITY + g.DEGREE * (p - 1) + 1
        self.VERIFIER_LEN = 1 + sum(g.ARITY + 1 for g in valid.GADGETS)

    # -- prover ----------------------------------------------------

    def prove(self, meas: list[F], prove_rand: list[F],
              joint_rand: list[F]) -> list[F]:
        if len(prove_rand) != self.PROVE_RAND_LEN:
            raise ValueError("incorrect prove randomness length")
        field = self.field

        # Wrap each gadget so the circuit evaluation records wire inputs.
        wrapped: list[_ProveGadget[F]] = []
        rest = prove_rand
        for (g, calls) in zip(self.valid.GADGETS, self.valid.GADGET_CALLS):
            (seeds, rest) = front(g.ARITY, rest)
            wrapped.append(_ProveGadget(field, list(seeds), g, calls))
        saved = self.valid.GADGETS
        self.valid.GADGETS = wrapped  # type: ignore[assignment]
        try:
            self.valid.eval(meas, joint_rand, 1)
        finally:
            self.valid.GADGETS = saved

        # Assemble the proof: per gadget, the wire seeds followed by the
        # coefficients of the composed gadget polynomial.
        proof: list[F] = []
        for (wg, inner, calls) in zip(wrapped, saved,
                                      self.valid.GADGET_CALLS):
            p = next_power_of_2(calls + 1)
            wire_polys = [poly_interp(field, wire) for wire in wg.wires]
            gadget_poly = inner.eval_poly(field, wire_polys)
            coeff_len = inner.DEGREE * (p - 1) + 1
            coeffs = list(gadget_poly) + \
                [field(0)] * (coeff_len - len(gadget_poly))
            proof += [wire[0] for wire in wg.wires]
            proof += coeffs[:coeff_len]
        return proof

    # -- verifier --------------------------------------------------

    def query(self, meas: list[F], proof: list[F], query_rand: list[F],
              joint_rand: list[F], num_shares: int) -> list[F]:
        if len(proof) != self.PROOF_LEN:
            raise ValueError("incorrect proof length")
        if len(query_rand) != self.QUERY_RAND_LEN:
            raise ValueError("incorrect query randomness length")
        field = self.field

        # Unpack the proof and wrap gadgets with the prover's claimed
        # gadget polynomials.
        wrapped: list[_QueryGadget[F]] = []
        rest = proof
        for (g, calls) in zip(self.valid.GADGETS, self.valid.GADGET_CALLS):
            p = next_power_of_2(calls + 1)
            (seeds, rest) = front(g.ARITY, rest)
            (coeffs, rest) = front(g.DEGREE * (p - 1) + 1, rest)
            wrapped.append(_QueryGadget(field, list(seeds), list(coeffs),
                                        g, calls))
        saved = self.valid.GADGETS
        self.valid.GADGETS = wrapped  # type: ignore[assignment]
        try:
            out = self.valid.eval(meas, joint_rand, num_shares)
        finally:
            self.valid.GADGETS = saved

        # Reduce the circuit outputs to a single element via a random
        # linear combination with independent weights.
        if self.valid.EVAL_OUTPUT_LEN > 1:
            (weights, query_rand) = front(self.valid.EVAL_OUTPUT_LEN,
                                          query_rand)
            v = field(0)
            for (weight, out_elem) in zip(weights, out):
                v += weight * out_elem
        else:
            v = out[0]

        # Spot-check each gadget's wires against its gadget polynomial
        # at a random point t outside the call domain.
        verifier = [v]
        for (wg, t) in zip(wrapped, query_rand):
            p = len(wg.wires[0])
            if t ** p == field(1):
                raise ValueError("query randomness hit the NTT domain")
            for wire in wg.wires:
                wire_poly = poly_interp(field, wire)
                verifier.append(poly_eval(field, wire_poly, t))
            verifier.append(poly_eval(field, wg.gadget_poly, t))
        return verifier

    def decide(self, verifier: list[F]) -> bool:
        if len(verifier) != self.VERIFIER_LEN:
            raise ValueError("incorrect verifier length")
        field = self.field
        ([v], rest) = front(1, verifier)
        if v != field(0):
            return False
        for g in self.valid.GADGETS:
            (x, rest) = front(g.ARITY, rest)
            ([y], rest) = front(1, rest)
            if g.eval(field, list(x)) != y:
                return False
        return True

    # -- passthroughs ----------------------------------------------

    def encode(self, measurement: W) -> list[F]:
        return self.valid.encode(measurement)

    def truncate(self, meas: list[F]) -> list[F]:
        return self.valid.truncate(meas)

    def decode(self, output: list[F], num_measurements: int) -> R:
        return self.valid.decode(output, num_measurements)

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        return self.valid.test_vec_set_type_param(test_vec)
