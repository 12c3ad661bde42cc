"""Training: losses, optimizer, steps and the trainer (mapping_tpu/train)."""
