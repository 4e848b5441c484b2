"""Field64's parameters (copy of the constants of `mastic_tpu/field.py`).
Only Field64 is ported so far; Field128 follows with the circuits that
use it."""


class Field64:
    MODULUS = 2 ** 32 * 4294967295 + 1  # 2^64 - 2^32 + 1
    GEN_ORDER = 2 ** 32
    ENCODED_SIZE = 8
