"""Input parsers of the port (copy of the pure-Python paths of
``racon_tpu.io``)."""
