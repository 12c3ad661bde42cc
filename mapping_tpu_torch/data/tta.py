"""Test-time augmentation on the device.

Counterpart of mapping_tpu/data/tta.py: each image expands into flip x
rotation (x optional colour shift) variants in the reference's order
(`tta_specs`, 16 specs by default), the network runs on all of them as one
flat batch, and the predictions are transformed back and aggregated with
mean / max / min / gmean. The flips follow the reference's `ud elif lr elif
colour` chain, so the (ud, lr) specs repeat the (ud, not lr) ones:
`dedupe_specs` keeps 12 unique forwards and weights the repeated ones by 2,
which aggregates to the 16-variant result.

Images and predictions are (B, H, W, C); `torch.rot90(x, k, dims=(1, 2))`
rotates counter-clockwise as `jnp.rot90(x, k, axes=(0, 1))` does per
image. Rotations need square images, as the 300^2 tiles are. The colour
shift's draws come from a torch.Generator on the host (one per image and
colour run, shared by that run's rotations, as the JAX package shares one
key); they cannot match JAX's random stream.
"""

from itertools import product
from typing import List, NamedTuple, Optional, Sequence

import torch

from mapping_tpu_torch.data.augment import color_shift, sample_color_shift


class TTASpec(NamedTuple):
    ud_flip: bool
    lr_flip: bool
    rotation: int  # degrees counter-clockwise, a multiple of 90
    color_shift: int  # 0 off, k > 0 the k-th colour run


def tta_specs(flip_ud=True, flip_lr=True, rotation=True,
              color_shift_runs=0) -> List[TTASpec]:
    """The variant list in the reference's order: the identity first, then
    the product of the options without the identity."""
    specs = [TTASpec(False, False, 0, 0)]
    ud_options = [True, False] if flip_ud else [False]
    lr_options = [True, False] if flip_lr else [False]
    rot_options = [0, 90, 180, 270] if rotation else [0]
    color_options = (list(range(1, color_shift_runs + 1))
                     if color_shift_runs else [0])
    for ud, lr, rot, color in product(ud_options, lr_options, rot_options,
                                      color_options):
        if not ud and not lr and rot == 0 and not color:
            continue
        specs.append(TTASpec(ud, lr, rot, color))
    return specs


def _forward(images, spec: TTASpec, draws=None):
    """(B, H, W, C): flip (ud elif lr elif colour), then rotate. `draws`
    holds each image's (choice, add) for a colour spec."""
    if spec.ud_flip:
        images = images.flip(1)
    elif spec.lr_flip:
        images = images.flip(2)
    elif spec.color_shift:
        images = torch.stack([color_shift(im.to(torch.float32), *draw)
                              for im, draw in zip(images, draws)])
    return torch.rot90(images, spec.rotation // 90, dims=(1, 2))


def _inverse(preds, spec: TTASpec):
    """(B, H, W, C) predictions: rotate back, then un-flip."""
    preds = torch.rot90(preds, -(spec.rotation // 90), dims=(1, 2))
    if spec.ud_flip:
        preds = preds.flip(1)
    elif spec.lr_flip:
        preds = preds.flip(2)
    return preds


def expand_batch(images, specs: Sequence[TTASpec],
                 generator: Optional[torch.Generator] = None):
    """(B, H, W, C) -> (B, V, H, W, C) forward variants. Colour runs draw
    one (choice, add) per image and run from `generator` (default: a new
    one seeded 0, so that a batch position always gets the same shift)."""
    runs = sorted({s.color_shift for s in specs if s.color_shift})
    draws = {}
    if runs:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = {k: [sample_color_shift(generator)
                     for _ in range(images.shape[0])] for k in runs}
    return torch.stack([_forward(images, s, draws.get(s.color_shift))
                        for s in specs], dim=1)


def inverse_batch(preds, specs: Sequence[TTASpec]):
    """(B, V, H, W, C) predictions -> transformed back, same shape."""
    return torch.stack([_inverse(preds[:, i], s)
                        for i, s in enumerate(specs)], dim=1)


def aggregate(preds, method: str = "gmean", dim: int = 1, weights=None):
    """Aggregate the variants axis `dim`. `weights` are per-variant
    multiplicities (from dedupe_specs), so that a deduplicated stack
    aggregates as the full one; max and min ignore them."""
    if weights is not None:
        shape = [1] * preds.ndim
        shape[dim] = -1
        w = torch.tensor(weights, dtype=torch.float32,
                         device=preds.device).reshape(shape)
        total = float(sum(weights))
    if method == "mean":
        if weights is None:
            return preds.mean(dim)
        return (preds * w).sum(dim) / total
    if method == "max":
        return preds.amax(dim)
    if method == "min":
        return preds.amin(dim)
    if method == "gmean":
        logs = torch.log(torch.clamp(preds, min=1e-12))
        if weights is None:
            return torch.exp(logs.mean(dim))
        return torch.exp((logs * w).sum(dim) / total)
    raise KeyError(f"unknown aggregation method {method!r}")


def dedupe_specs(specs: Sequence[TTASpec]):
    """(unique specs, multiplicities): specs that apply the same transform
    under the `ud elif lr elif colour` chain collapse into the first."""
    canon = {}
    for spec in specs:
        if spec.ud_flip:
            key = ("ud", spec.rotation)
        elif spec.lr_flip:
            key = ("lr", spec.rotation)
        elif spec.color_shift:
            key = ("color", spec.color_shift, spec.rotation)
        else:
            key = ("id", spec.rotation)
        canon.setdefault(key, [spec, 0])[1] += 1
    return [s for s, _ in canon.values()], [n for _, n in canon.values()]


def tta_wrap_predict(predict_probs, specs: Sequence[TTASpec],
                     method: str = "gmean", dedupe: bool = True):
    """(images (B, H, W, C_in) [, generator]) -> aggregated (B, H, W, C)
    probabilities, with `predict_probs` run once on the B x V variants as
    one flat batch. `dedupe` runs each distinct transform once and weights
    it by its multiplicity (16 -> 12 forwards on the default list)."""
    weights = None
    if dedupe:
        specs, counts = dedupe_specs(specs)
        if any(c > 1 for c in counts):
            weights = counts
    v = len(specs)

    def run(images, generator=None):
        b = images.shape[0]
        expanded = expand_batch(images, specs, generator)
        probs = predict_probs(expanded.reshape((b * v,)
                                               + expanded.shape[2:]))
        probs = inverse_batch(probs.reshape((b, v) + probs.shape[1:]), specs)
        return aggregate(probs, method, weights=weights)

    return run
