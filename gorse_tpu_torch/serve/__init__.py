"""gorse_tpu_torch.serve (port of gorse_tpu.serve)."""
