"""Counterpart of mapping_tpu.data (see each module)."""
