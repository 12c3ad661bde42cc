"""Counterpart of mapping_tpu.ops (see each module)."""
