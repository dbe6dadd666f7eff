"""Host helpers of the port (copies of ``racon_tpu.utils``)."""
