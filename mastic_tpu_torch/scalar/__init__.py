"""The scalar layer: copies of the JAX package's pure-Python modules
(`mastic_tpu/common.py`, `dst.py`, `field.py`, `aes.py`, `keccak.py`,
`xof.py`, `flp/`, `vidpf.py`, `vdaf.py`, `mastic.py`), one report at a
time, with the XOFs' true rejection loop.

The batched engine reads its constants from here, the tests hold it
byte for byte against the JAX package's, and the drivers run one
report through it where the batched sampler fired
(`drivers/heavy_hitters.py::splice_rejected`).  It needs the standard
library only.
"""
