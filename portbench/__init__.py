"""The benchmark of the PyTorch and CUDA port, `mastic_tpu_torch`: one
run of one cell is `python3 -m portbench.run` (see `run.py` and
README.md)."""
