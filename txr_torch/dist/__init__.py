"""Multi-process rendering and training over ``torch.distributed``
(txr/dist/): rank layouts and worlds (``mesh``), ray-sharded render and
train step (``sharded``), the primitive-sharded ring sweep (``ring``)."""
