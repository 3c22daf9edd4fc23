"""User-facing examples of the single-host stack, run as
``python -m repro_torch.examples.<name> [--device cpu]``."""
