"""Serving: forward + postprocess for one batch, enqueued on the device.

Counterpart of mapping_tpu/infer/serving.py `FusedServe` on one device.
`dispatch` enqueues the forward, softmax, resize, threshold, CCL and scores
on the current CUDA stream and returns without waiting; `collect` copies
the compact outputs to the host, which waits for them, and runs the
overflow escalation. A serving loop that dispatches batch k+1 before it
collects batch k keeps the device busy while the host handles batch k.
Mesh and spatial serving (ROADMAP item 16), TTA and the pad-mode centre
crop (item 14) are not ported yet.
"""

from typing import Callable, Optional, Tuple

import torch

from mapping_tpu_torch.infer.postprocess import (MAX_INSTANCES,
                                                 escalate_overflow,
                                                 fused_postprocess)


class FusedServe:
    """images (B, H, W, 3) normalised float -> numpy labels (B, L, th, tw)
    int16, scores (B, L, N) float32, areas (B, L, N) int32.

    probs_fn(images) -> (B, H, W, C) softmax probabilities, float32.
    """

    def __init__(self, probs_fn: Callable, *, target_size: Tuple[int, int],
                 category_layers: Tuple[int, ...],
                 active_layers: Optional[Tuple[int, ...]] = None,
                 erode_size: int = 0, dilate_size: int = 0,
                 max_instances: int = MAX_INSTANCES):
        self._probs_fn = probs_fn
        self._post = dict(target_size=tuple(target_size),
                          category_layers=tuple(category_layers),
                          active_layers=active_layers,
                          erode_size=int(erode_size),
                          dilate_size=int(dilate_size))
        self._base_max_instances = int(max_instances)

    @torch.inference_mode()
    def _run(self, images, max_instances):
        probs = self._probs_fn(images)
        labels, scores, areas = fused_postprocess(
            probs, max_instances=max_instances, **self._post)
        return labels_i16(labels), scores, areas

    def dispatch(self, images):
        """Enqueue one batch; returns a handle for `collect`. Does not
        synchronise."""
        return self._run(images, self._base_max_instances), images

    def collect(self, handle):
        """Copy a dispatched batch's outputs to the host (this waits for
        them) and re-run images that overflow the instance pad with a
        doubled pad, up to MAX_INSTANCES_CEILING."""
        outs_d, images = handle

        def rerun(idx, pad):
            sel = torch.as_tensor(idx, device=images.device)
            return [o.cpu().numpy() for o in self._run(images[sel], pad)]

        return escalate_overflow([o.cpu().numpy() for o in outs_d], rerun,
                                 self._base_max_instances)

    def __call__(self, images):
        return self.collect(self.dispatch(images))


def labels_i16(labels):
    """int32 labels -> int16 for the copy to the host, clamped at 32767 so
    a map with more components stays above every escalation pad instead of
    wrapping negative."""
    return torch.clamp(labels, max=32767).to(torch.int16)
