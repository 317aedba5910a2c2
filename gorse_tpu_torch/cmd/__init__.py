"""Entry points of the port's node processes (port of gorse_tpu/cmd/)."""
