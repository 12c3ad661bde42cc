"""Measurement entry points of the port (mapping_tpu's tools/)."""
