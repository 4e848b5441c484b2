"""Command-line tools of the port (run as `python -m
mastic_tpu_torch.tools.<name>`)."""
