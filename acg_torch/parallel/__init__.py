"""The distributed layer: the device list (``mesh``), the halo schedule
and its transports (``halo``, ``rdma_halo``), and the sharded operator
(``sharded``)."""
