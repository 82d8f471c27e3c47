"""The training step and loop, checkpoints and elastic restart (ports of
``repro.train``) on one device."""
