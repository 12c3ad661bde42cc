"""Counterpart of mapping_tpu.models (see each module)."""
