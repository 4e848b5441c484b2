"""The parameters of Field64 and Field128 (copy of the constants of
`mastic_tpu/field.py`)."""


class Field64:
    MODULUS = 2 ** 32 * 4294967295 + 1  # 2^64 - 2^32 + 1
    GEN_ORDER = 2 ** 32
    ENCODED_SIZE = 8


class Field128:
    MODULUS = 2 ** 66 * 4611686018427387897 + 1  # 2^128 - 7 * 2^66 + 1
    GEN_ORDER = 2 ** 66
    ENCODED_SIZE = 16
