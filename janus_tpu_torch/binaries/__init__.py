"""Binaries of the PyTorch port: daemons + ops CLI (reference:
aggregator/src/binaries/); ``python -m janus_tpu_torch.binaries``."""
