"""Observability: the live residual monitor (``acg_torch.obs.monitor``)."""
