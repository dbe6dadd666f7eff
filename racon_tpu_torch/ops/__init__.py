"""Device engines and kernels of the port (counterparts of
``racon_tpu.ops``)."""
