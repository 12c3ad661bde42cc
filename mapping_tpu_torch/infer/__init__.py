"""Counterpart of mapping_tpu.infer (see each module)."""
