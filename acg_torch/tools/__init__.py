"""Command-line tools beside the solver program (``python -m
acg_torch.tools.<name>``)."""
