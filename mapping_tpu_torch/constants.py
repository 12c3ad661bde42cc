"""Constants of the serving path, equal to mapping_tpu/constants.py.

A copy, not an import: the port runs where the JAX package is not
installed, and tests/test_torch_serving.py checks that the values agree.
"""

# CATEGORY_IDS[i] is the COCO category id emitted for class-channel i;
# None means "do not emit annotations for this channel" (background).
CATEGORY_IDS = [None, 100]

# Number of threshold layers per category: 1 -> [0.5], 19 -> [0.05..0.95].
CATEGORY_LAYERS = [1, 1]

# ImageNet normalization used by all pretrained encoders.
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
