"""The five validity circuits of the Mastic instantiations (copy of the
parameters, encodings and truncations of `mastic_tpu/flp/circuits.py`
and of the gadget constants of `mastic_tpu/flp/flp.py`).

Every circuit has one gadget of degree 2: Mul (Count), PolyEval
[0, -1, 1] (Sum) or a ParallelSum of `chunk_length` Mul calls (SumVec,
Histogram, MultihotCountVec).  The FLP lengths follow from the gadget
as `FlpBBCGGI19` derives them.  Field elements are ints in [0, p).
"""

from ..scalar.common import next_power_of_2
from ..scalar.field import Field64, Field128


def _bits(value: int, bits: int) -> list:
    """The little-endian bit vector of `value` (encode_into_bit_vector)."""
    if value >= 2 ** bits:
        raise ValueError("value too large for bit length")
    return [(value >> i) & 1 for i in range(bits)]


def _from_bits(field, vec: list) -> int:
    """sum 2^i vec[i] mod p (decode_from_bit_vector)."""
    return sum(x << i for (i, x) in enumerate(vec)) % field.MODULUS


class Circuit:
    """A validity circuit's parameters; subclasses set the field, the
    gadget and the lengths.  GADGET is "mul", "polyeval" or
    "parallel_mul"."""

    field: type
    GADGET: str
    GADGET_ARITY: int
    GADGET_DEGREE = 2
    GADGET_CALLS: int
    JOINT_RAND_LEN: int
    MEAS_LEN: int
    OUTPUT_LEN: int
    EVAL_OUTPUT_LEN: int

    @property
    def PROVE_RAND_LEN(self) -> int:
        return self.GADGET_ARITY

    @property
    def QUERY_RAND_LEN(self) -> int:
        # One reduction weight per circuit output (when there is more
        # than one), plus the gadget's spot-check point.
        extra = self.EVAL_OUTPUT_LEN if self.EVAL_OUTPUT_LEN > 1 else 0
        return 1 + extra

    @property
    def PROOF_LEN(self) -> int:
        p = next_power_of_2(self.GADGET_CALLS + 1)
        return self.GADGET_ARITY + self.GADGET_DEGREE * (p - 1) + 1

    @property
    def VERIFIER_LEN(self) -> int:
        return 1 + self.GADGET_ARITY + 1

    def encode(self, measurement) -> list:
        raise NotImplementedError

    def truncate(self, meas: list) -> list:
        raise NotImplementedError

    def decode(self, output: list):
        return list(output)


class Count(Circuit):
    """f(x) = x^2 - x: valid iff the measurement is 0 or 1.  One Mul
    gadget called once."""

    field = Field64
    GADGET = "mul"
    GADGET_ARITY = 2
    GADGET_CALLS = 1
    JOINT_RAND_LEN = 0
    MEAS_LEN = 1
    OUTPUT_LEN = 1
    EVAL_OUTPUT_LEN = 1

    def encode(self, measurement: int) -> list:
        if measurement not in range(2):
            raise ValueError("measurement out of range")
        return [measurement]

    def truncate(self, meas: list) -> list:
        return list(meas)

    def decode(self, output: list) -> int:
        return output[0]


class Sum(Circuit):
    """Dual bit-decomposition range check: meas encodes m and m + offset
    in `bits` bits each, proving 0 <= m <= max_measurement.  PolyEval
    [0, -1, 1] (z^2 - z) called on every bit."""

    field = Field64
    GADGET = "polyeval"
    GADGET_ARITY = 1
    JOINT_RAND_LEN = 0
    OUTPUT_LEN = 1

    def __init__(self, max_measurement: int):
        self.max_measurement = max_measurement
        self.bits = max_measurement.bit_length()
        self.offset = 2 ** self.bits - 1 - max_measurement
        self.MEAS_LEN = 2 * self.bits
        self.EVAL_OUTPUT_LEN = 2 * self.bits + 1
        self.GADGET_CALLS = 2 * self.bits

    def encode(self, measurement: int) -> list:
        if measurement not in range(self.max_measurement + 1):
            raise ValueError("measurement out of range")
        return _bits(measurement, self.bits) + \
            _bits(measurement + self.offset, self.bits)

    def truncate(self, meas: list) -> list:
        return [_from_bits(self.field, meas[:self.bits])]

    def decode(self, output: list) -> int:
        return output[0]


class _ParallelSumCircuit(Circuit):
    """Random-linear-combination bit checks as a ParallelSum of
    `chunk_length` Mul calls over the measurement's chunks; one
    joint-rand element per call."""

    field = Field128
    GADGET = "parallel_mul"

    def _set_calls(self, chunk_length: int) -> None:
        self.chunk_length = chunk_length
        self.GADGET_ARITY = 2 * chunk_length
        self.GADGET_CALLS = (self.MEAS_LEN + chunk_length - 1) // chunk_length
        self.JOINT_RAND_LEN = self.GADGET_CALLS


class SumVec(_ParallelSumCircuit):
    """A vector of `length` sums of `bits` bits each."""

    EVAL_OUTPUT_LEN = 1

    def __init__(self, length: int, bits: int, chunk_length: int):
        self.length = length
        self.bits = bits
        self.MEAS_LEN = length * bits
        self.OUTPUT_LEN = length
        self._set_calls(chunk_length)

    def encode(self, measurement: list) -> list:
        if len(measurement) != self.length:
            raise ValueError("incorrect measurement length")
        encoded = []
        for val in measurement:
            if val not in range(2 ** self.bits):
                raise ValueError("measurement entry out of range")
            encoded += _bits(val, self.bits)
        return encoded

    def truncate(self, meas: list) -> list:
        return [_from_bits(self.field, meas[i * self.bits:(i + 1) * self.bits])
                for i in range(self.length)]


class Histogram(_ParallelSumCircuit):
    """A one-hot vector of `length` buckets."""

    EVAL_OUTPUT_LEN = 2

    def __init__(self, length: int, chunk_length: int):
        self.length = length
        self.MEAS_LEN = length
        self.OUTPUT_LEN = length
        self._set_calls(chunk_length)

    def encode(self, measurement: int) -> list:
        if measurement not in range(self.length):
            raise ValueError("measurement out of range")
        encoded = [0] * self.length
        encoded[measurement] = 1
        return encoded

    def truncate(self, meas: list) -> list:
        return list(meas)


class MultihotCountVec(_ParallelSumCircuit):
    """A boolean vector with at most `max_weight` ones; the claimed
    weight rides in an offset bit encoding and is checked against the
    actual weight."""

    EVAL_OUTPUT_LEN = 2

    def __init__(self, length: int, max_weight: int, chunk_length: int):
        self.length = length
        self.max_weight = max_weight
        self.bits_for_weight = max_weight.bit_length()
        self.offset = 2 ** self.bits_for_weight - 1 - max_weight
        self.MEAS_LEN = length + self.bits_for_weight
        self.OUTPUT_LEN = length
        self._set_calls(chunk_length)

    def encode(self, measurement: list) -> list:
        if len(measurement) != self.length:
            raise ValueError("incorrect measurement length")
        weight = sum(int(x) for x in measurement)
        if weight > self.max_weight:
            raise ValueError("measurement weight too large")
        return [int(x) for x in measurement] + \
            _bits(weight + self.offset, self.bits_for_weight)

    def truncate(self, meas: list) -> list:
        return list(meas[:self.length])
