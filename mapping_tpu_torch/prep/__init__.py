"""Counterpart of mapping_tpu.prep: COCO annotations -> the mask, distance
and size target files that training reads (see prep/targets.py)."""
