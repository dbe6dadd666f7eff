"""Host domain model and polishing pipeline of the port (copies of
``racon_tpu.core``, trimmed to the contig-polishing path)."""
