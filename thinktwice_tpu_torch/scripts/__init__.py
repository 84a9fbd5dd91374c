"""Training entry points of the port: `python -m thinktwice_tpu_torch.scripts.<name>`."""
