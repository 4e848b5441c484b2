"""FLP circuit parameters (copy of the Count circuit's constants in
`mastic_tpu/flp/circuits.py`).  Only Count is ported so far."""


class Count:
    """f(x) = x^2 - x: valid iff the measurement is 0 or 1.  One Mul
    gadget called once."""

    GADGET = "mul"
    GADGET_ARITY = 2
    GADGET_DEGREE = 2
    GADGET_CALLS = 1
    JOINT_RAND_LEN = 0
    MEAS_LEN = 1
    OUTPUT_LEN = 1
    EVAL_OUTPUT_LEN = 1
    PROVE_RAND_LEN = 2
    QUERY_RAND_LEN = 1
    PROOF_LEN = 5
    VERIFIER_LEN = 4

    def encode(self, measurement: int) -> list:
        if measurement not in range(2):
            raise ValueError("measurement out of range")
        return [measurement]
