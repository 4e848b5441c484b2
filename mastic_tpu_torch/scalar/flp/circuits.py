"""Copy of `mastic_tpu/flp/circuits.py`: the five validity circuits of
the Mastic instantiations (draft-irtf-cfrg-vdaf-13 §7.4).

Parameters:
  Count               F64   MEAS_LEN 1, PROOF_LEN 5,  verifier 4, no jr
  Sum(max=7)          F64   MEAS_LEN 6, PROOF_LEN 16, verifier 3, no jr
  SumVec(3,1,1)       F128  MEAS_LEN 3, PROOF_LEN 9,  verifier 4, jr
  Histogram(4,2)      F128  MEAS_LEN 4, PROOF_LEN 11, verifier 6, jr
  MultihotCountVec(4,2,2) F128 MEAS_LEN 6, PROOF_LEN 11, verifier 6, jr
"""

from typing import Generic

from ..field import F
from .flp import Gadget, Mul, ParallelSum, PolyEval, Valid


class Count(Valid[int, int, F]):
    """f(x) = x^2 - x: valid iff the measurement is 0 or 1."""

    JOINT_RAND_LEN = 0
    MEAS_LEN = 1
    OUTPUT_LEN = 1
    EVAL_OUTPUT_LEN = 1

    def __init__(self, field: type[F]):
        self.field = field
        self.GADGETS: list[Gadget[F]] = [Mul()]
        self.GADGET_CALLS = [1]

    def eval(self, meas: list[F], joint_rand: list[F],
             num_shares: int) -> list[F]:
        self.check_valid_eval(meas, joint_rand)
        squared = self.GADGETS[0].eval(self.field, [meas[0], meas[0]])
        return [squared - meas[0]]

    def encode(self, measurement: int) -> list[F]:
        if measurement not in range(2):
            raise ValueError("measurement out of range")
        return [self.field(measurement)]

    def truncate(self, meas: list[F]) -> list[F]:
        if len(meas) != 1:
            raise ValueError("incorrect measurement length")
        return meas

    def decode(self, output: list[F],
               _num_measurements: int) -> int:
        return output[0].int()

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        return []


class Sum(Valid[int, int, F]):
    """Dual bit-decomposition range check: meas encodes `m` and
    `m + offset` in `bits` bits each; both must be boolean and decode
    consistently, proving 0 <= m <= max_measurement."""

    EVAL_OUTPUT_LEN: int
    JOINT_RAND_LEN = 0
    OUTPUT_LEN = 1

    def __init__(self, field: type[F], max_measurement: int):
        self.field = field
        self.max_measurement = max_measurement
        self.bits = max_measurement.bit_length()
        self.offset = self.field(2 ** self.bits - 1 - max_measurement)
        self.MEAS_LEN = 2 * self.bits
        self.EVAL_OUTPUT_LEN = 2 * self.bits + 1
        self.GADGETS: list[Gadget[F]] = [PolyEval([0, -1, 1])]
        self.GADGET_CALLS = [2 * self.bits]

    def eval(self, meas: list[F], joint_rand: list[F],
             num_shares: int) -> list[F]:
        self.check_valid_eval(meas, joint_rand)
        shares_inv = self.field(num_shares).inv()
        out = []
        for b in meas:
            out.append(self.GADGETS[0].eval(self.field, [b]))
        range_check = self.offset * shares_inv + \
            self.field.decode_from_bit_vector(meas[:self.bits]) - \
            self.field.decode_from_bit_vector(meas[self.bits:])
        out.append(range_check)
        return out

    def encode(self, measurement: int) -> list[F]:
        if measurement not in range(self.max_measurement + 1):
            raise ValueError("measurement out of range")
        return self.field.encode_into_bit_vector(measurement, self.bits) + \
            self.field.encode_into_bit_vector(
                measurement + self.offset.int(), self.bits)

    def truncate(self, meas: list[F]) -> list[F]:
        return [self.field.decode_from_bit_vector(meas[:self.bits])]

    def decode(self, output: list[F],
               _num_measurements: int) -> int:
        return output[0].int()

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        test_vec["max_measurement"] = self.max_measurement
        return ["max_measurement"]


class _ParallelSumRangeChecks(Generic[F]):
    """Shared helper: random-linear-combination bit checks evaluated as
    a ParallelSum of Mul gadget calls over fixed-size chunks
    (vdaf-13 §7.4.3)."""

    field: type[F]
    GADGETS: list[Gadget[F]]

    def parallel_sum_range_checks(self, meas: list[F],
                                  joint_rand: list[F],
                                  chunk_length: int,
                                  num_shares: int) -> F:
        field = self.field
        shares_inv = field(num_shares).inv()
        out = field(0)
        for (chunk_index, r) in enumerate(joint_rand):
            inputs: list[F] = []
            r_power = r
            for j in range(chunk_length):
                index = chunk_index * chunk_length + j
                meas_elem = meas[index] if index < len(meas) else field(0)
                inputs.append(r_power * meas_elem)
                inputs.append(meas_elem - shares_inv)
                r_power = r_power * r
            out += self.GADGETS[0].eval(field, inputs)
        return out


class SumVec(_ParallelSumRangeChecks[F], Valid[list[int], list[int], F]):
    """Vector of `length` sums, each in `bits` bits."""

    EVAL_OUTPUT_LEN = 1

    def __init__(self, field: type[F], length: int, bits: int,
                 chunk_length: int):
        self.field = field
        self.length = length
        self.bits = bits
        self.chunk_length = chunk_length
        self.MEAS_LEN = length * bits
        self.OUTPUT_LEN = length
        self.GADGET_CALLS = [
            (length * bits + chunk_length - 1) // chunk_length]
        self.JOINT_RAND_LEN = self.GADGET_CALLS[0]
        self.GADGETS: list[Gadget[F]] = [
            ParallelSum(Mul(), chunk_length)]

    def eval(self, meas: list[F], joint_rand: list[F],
             num_shares: int) -> list[F]:
        self.check_valid_eval(meas, joint_rand)
        return [self.parallel_sum_range_checks(
            meas, joint_rand, self.chunk_length, num_shares)]

    def encode(self, measurement: list) -> list[F]:
        if len(measurement) != self.length:
            raise ValueError("incorrect measurement length")
        encoded = []
        for val in measurement:
            if val not in range(2 ** self.bits):
                raise ValueError("measurement entry out of range")
            encoded += self.field.encode_into_bit_vector(val, self.bits)
        return encoded

    def truncate(self, meas: list[F]) -> list[F]:
        return [
            self.field.decode_from_bit_vector(
                meas[i * self.bits:(i + 1) * self.bits])
            for i in range(self.length)
        ]

    def decode(self, output: list[F],
               _num_measurements: int) -> list[int]:
        return [x.int() for x in output]

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        test_vec["length"] = self.length
        test_vec["bits"] = self.bits
        test_vec["chunk_length"] = self.chunk_length
        return ["length", "bits", "chunk_length"]


class Histogram(_ParallelSumRangeChecks[F], Valid[int, list[int], F]):
    """One-hot vector of `length` buckets."""

    EVAL_OUTPUT_LEN = 2

    def __init__(self, field: type[F], length: int, chunk_length: int):
        self.field = field
        self.length = length
        self.chunk_length = chunk_length
        self.MEAS_LEN = length
        self.OUTPUT_LEN = length
        self.GADGET_CALLS = [(length + chunk_length - 1) // chunk_length]
        self.JOINT_RAND_LEN = self.GADGET_CALLS[0]
        self.GADGETS: list[Gadget[F]] = [
            ParallelSum(Mul(), chunk_length)]

    def eval(self, meas: list[F], joint_rand: list[F],
             num_shares: int) -> list[F]:
        self.check_valid_eval(meas, joint_rand)
        range_check = self.parallel_sum_range_checks(
            meas, joint_rand, self.chunk_length, num_shares)
        shares_inv = self.field(num_shares).inv()
        sum_check = -shares_inv
        for b in meas:
            sum_check += b
        return [range_check, sum_check]

    def encode(self, measurement: int) -> list[F]:
        if measurement not in range(self.length):
            raise ValueError("measurement out of range")
        encoded = self.field.zeros(self.length)
        encoded[measurement] = self.field(1)
        return encoded

    def truncate(self, meas: list[F]) -> list[F]:
        return meas

    def decode(self, output: list[F],
               _num_measurements: int) -> list[int]:
        return [x.int() for x in output]

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        test_vec["length"] = self.length
        test_vec["chunk_length"] = self.chunk_length
        return ["length", "chunk_length"]


class MultihotCountVec(_ParallelSumRangeChecks[F],
                       Valid[list[bool], list[int], F]):
    """Boolean vector with at most `max_weight` ones; the claimed weight
    is carried in an offset bit encoding and cross-checked against the
    actual weight."""

    EVAL_OUTPUT_LEN = 2

    def __init__(self, field: type[F], length: int, max_weight: int,
                 chunk_length: int):
        self.field = field
        self.length = length
        self.max_weight = max_weight
        self.chunk_length = chunk_length
        self.bits_for_weight = max_weight.bit_length()
        self.offset = self.field(
            2 ** self.bits_for_weight - 1 - max_weight)
        self.MEAS_LEN = length + self.bits_for_weight
        self.OUTPUT_LEN = length
        self.GADGET_CALLS = [
            (self.MEAS_LEN + chunk_length - 1) // chunk_length]
        self.JOINT_RAND_LEN = self.GADGET_CALLS[0]
        self.GADGETS: list[Gadget[F]] = [
            ParallelSum(Mul(), chunk_length)]

    def eval(self, meas: list[F], joint_rand: list[F],
             num_shares: int) -> list[F]:
        self.check_valid_eval(meas, joint_rand)
        range_check = self.parallel_sum_range_checks(
            meas, joint_rand, self.chunk_length, num_shares)
        shares_inv = self.field(num_shares).inv()
        count_vec = meas[:self.length]
        weight = self.field(0)
        for b in count_vec:
            weight += b
        weight_reported = \
            self.field.decode_from_bit_vector(meas[self.length:])
        weight_check = self.offset * shares_inv + weight - weight_reported
        return [range_check, weight_check]

    def encode(self, measurement: list) -> list[F]:
        if len(measurement) != self.length:
            raise ValueError("incorrect measurement length")
        count_vec = [self.field(int(x)) for x in measurement]
        weight = sum(int(x) for x in measurement)
        if weight > self.max_weight:
            raise ValueError("measurement weight too large")
        encoded_weight = self.field.encode_into_bit_vector(
            weight + self.offset.int(), self.bits_for_weight)
        return count_vec + encoded_weight

    def truncate(self, meas: list[F]) -> list[F]:
        return meas[:self.length]

    def decode(self, output: list[F],
               _num_measurements: int) -> list[int]:
        return [x.int() for x in output]

    def test_vec_set_type_param(self, test_vec: dict) -> list[str]:
        test_vec["length"] = self.length
        test_vec["max_weight"] = self.max_weight
        test_vec["chunk_length"] = self.chunk_length
        return ["length", "max_weight", "chunk_length"]
