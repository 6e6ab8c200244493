"""Execution strategies (one device, and the data-parallel flavors over
``torch.distributed``), their step functions, the rank layout, ZeRO
sharding and the gradient sync."""
