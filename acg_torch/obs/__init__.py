"""Observability: the live residual monitor (``acg_torch.obs.monitor``),
host phase spans (``trace``), the runtime metrics registry (``metrics``)
and per-request timelines with the flight recorder (``events``)."""
