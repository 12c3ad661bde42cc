"""Post-training int8 quantisation of the serving forward.

Counterpart of mapping_tpu/models/quantize.py. Every calibrated
Conv2d / ConvTranspose2d of the serving model (BN-folded where the family
folds) is replaced by an int8 conv:

    x (compute dtype) -> round(x / s_x) as int8 -> int8 conv (int32
    accumulator) -> * (s_w[c_out] * s_x) + bias -> compute dtype

Activations between convs stay in the compute dtype; only the
contraction runs in int8. Scales are static:
- weights: symmetric per-output-channel absmax / 127 of the float32 kernel
  (`build_qtable`), rounded half to even and clipped to +-127, as the JAX
  package's `np.round` does;
- activations: symmetric per-tensor absmax / 127 over calibration batches
  (`collect_stats`: forward pre-hooks on every conv of the float forward,
  where the JAX package intercepts the Flax conv calls).

The int8 conv is an im2col product: the quantised input (NHWC) is padded
(zero-inserted first for a transposed conv), its kH x kW shifted views are
concatenated along the channels in the HWIO order of the JAX kernel, and
`torch._int_mm` multiplies that (rows, kH kW C_in) int8 matrix by the
(kH kW C_in, C_out) int8 kernel into int32. The JAX package computes the
same integers with `lax.conv_general_dilated(...,
preferred_element_type=int32)`; the product is exact in int32 on either
side. On the card `_int_mm` wants more than 16 rows and both the inner
and the outer dimension a multiple of 8, so the matrices are padded with
zeros, which is exact. A transposed conv is the Flax `ConvTranspose`
(`transpose_kernel=False`) that the port's `ConvTranspose2d` reproduces:
the input zero-inserted by the stride, padded by d (k - 1) - p (plus the
output padding on the high side), then correlated with the kernel flipped
back to the Flax layout.

`quantized_probs_fn` composes it for serving, with the weight-freshness
contract of the JAX package: with `version_fn`, `get_packed()`
recalibrates the whole qtable when the version drifts, synchronously by
default, or on a background thread after `get_packed.set_async(True)`
(the daemon's mode) while the previous snapshot keeps serving;
`get_packed.stats` counts recalibrations and batches served stale.
"""

import copy
import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mapping_tpu_torch.parallel.mesh import Replicas
from mapping_tpu_torch.train.trainer import SoftmaxProbs

logger = logging.getLogger(__name__)

_EPS = 1e-12
_CONVS = (nn.Conv2d, nn.ConvTranspose2d)
#: bytes of one im2col chunk; larger batches are unfolded in chunks
IM2COL_BYTES = 1 << 30
#: `torch._int_mm` calls, one per im2col chunk
MATMULS = {"int_mm": 0}


# ---------------------------------------------------------------------------
# the model's convs
# ---------------------------------------------------------------------------

def conv_kernel_paths(model: nn.Module) -> Dict[str, nn.Module]:
    """{module name: module} for every Conv2d / ConvTranspose2d of
    `model`; the names are the keys of `collect_stats` and the qtable."""
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, _CONVS)}


def _supported(mod) -> bool:
    return mod.groups == 1 and mod.padding_mode == "zeros"


def _to_hwio(mod, w: torch.Tensor) -> torch.Tensor:
    """A tensor in the module's weight layout -> the JAX (kH, kW, I, O)
    layout: a ConvTranspose2d's weight (I, O, kH, kW) is the Flax kernel
    flipped (models/convert.py `_deconv`), so the flip is undone."""
    if isinstance(mod, nn.ConvTranspose2d):
        return w.flip(2, 3).permute(2, 3, 0, 1)
    return w.permute(2, 3, 1, 0)


def _from_hwio(mod, w_hwio: torch.Tensor) -> torch.Tensor:
    """The inverse of `_to_hwio`."""
    if isinstance(mod, nn.ConvTranspose2d):
        return w_hwio.permute(2, 3, 0, 1).flip(2, 3)
    return w_hwio.permute(3, 2, 0, 1)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def collect_stats(model: nn.Module, batches,
                  forward: Optional[Callable] = None) -> Dict[str, float]:
    """Max over calibration batches of each conv input's |x| max, by
    module name. `forward(batch)` runs the float forward (default
    `model(batch)`), in inference mode; the maxima stay on the device
    until the end."""
    acc: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(_mod, args):
            m = torch.amax(torch.abs(args[0])).to(torch.float32)
            acc[name] = m if name not in acc else torch.maximum(acc[name], m)
        return record

    handles = [mod.register_forward_pre_hook(hook(name))
               for name, mod in conv_kernel_paths(model).items()]
    try:
        with torch.inference_mode():
            for batch in batches:
                (forward or model)(batch)
    finally:
        for h in handles:
            h.remove()
    names = list(acc)
    values = torch.stack([acc[n] for n in names]).cpu().tolist() \
        if names else []
    return dict(zip(names, values))


# ---------------------------------------------------------------------------
# weight quantisation
# ---------------------------------------------------------------------------

def build_qtable(model: nn.Module, act_stats: Dict[str, float],
                 min_dim: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: {"w": int8 weight in the module's layout, "w_scale": float32
    (c_out,), "x_scale": float32 scalar, "bias": float32 (c_out,) where
    the conv has one}} for every conv with a calibrated input; a conv
    never seen in calibration stays float. `min_dim` skips convs whose
    contraction depth kH kW c_in or c_out is below it (0: quantise every
    conv), as the JAX package's cost gate does."""
    qtable = {}
    for name, mod in conv_kernel_paths(model).items():
        amax = act_stats.get(name)
        if amax is None:
            continue
        kernel = _to_hwio(mod, mod.weight.detach().to(torch.float32))
        kh, kw, c_in, c_out = kernel.shape
        if min_dim and min(kh * kw * c_in, c_out) < min_dim:
            continue
        w_scale = torch.clamp_min(torch.amax(torch.abs(kernel), (0, 1, 2))
                                  / 127.0, _EPS)
        w_q = torch.clamp(torch.round(kernel / w_scale), -127, 127).to(
            torch.int8)
        entry = {
            "w": _from_hwio(mod, w_q).contiguous(),
            "w_scale": w_scale,
            "x_scale": torch.tensor(max(float(amax) / 127.0, _EPS),
                                    dtype=torch.float32,
                                    device=kernel.device),
        }
        if mod.bias is not None:
            entry["bias"] = mod.bias.detach().to(torch.float32).clone()
        qtable[name] = entry
    return qtable


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------

def _quantize_input(x, x_scale):
    q = torch.round(x.to(torch.float32) * (1.0 / x_scale))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def _round_up(n, m):
    return -(-n // m) * m


def _geometry(mod) -> Dict[str, Tuple[int, int]]:
    """stride, dilation, input dilation and (lo, hi) pads per spatial dim
    of the correlation that `mod` computes."""
    kh, kw = mod.kernel_size
    dil = tuple(mod.dilation)
    if isinstance(mod, nn.ConvTranspose2d):
        pads = tuple((d * (k - 1) - p, d * (k - 1) - p + op)
                     for k, d, p, op in zip((kh, kw), dil, mod.padding,
                                            mod.output_padding))
        return dict(stride=(1, 1), dilation=dil, lhs_dilation=tuple(
            mod.stride), pads=pads)
    if isinstance(mod.padding, str):
        totals = ([d * (k - 1) for k, d in zip((kh, kw), dil)]
                  if mod.padding == "same" else [0, 0])
        pads = tuple((t // 2, t - t // 2) for t in totals)
    else:
        pads = tuple((p, p) for p in mod.padding)
    return dict(stride=tuple(mod.stride), dilation=dil, lhs_dilation=(1, 1),
                pads=pads)


def weight_matrix(w_hwio: torch.Tensor) -> torch.Tensor:
    """(kH, kW, I, O) int8 -> (O8, K8) int8, K = kH kW I in HWIO order,
    both padded with zeros to multiples of 8; `_int_mm` takes its
    transpose (the column-major right operand)."""
    kh, kw, c_in, c_out = w_hwio.shape
    k = kh * kw * c_in
    mat = w_hwio.reshape(k, c_out).t()
    return F.pad(mat, (0, _round_up(k, 8) - k,
                       0, _round_up(c_out, 8) - c_out)).contiguous()


def int8_conv(qx: torch.Tensor, w_mat: torch.Tensor, kernel_size,
              c_out: int, stride=(1, 1), dilation=(1, 1),
              lhs_dilation=(1, 1), pads=((0, 0), (0, 0))) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B, Ho, Wo, c_out) int32: the correlation of
    the (zero-inserted by `lhs_dilation`, then padded) input with the
    kernel whose `weight_matrix` is `w_mat`, as im2col + `torch._int_mm`,
    in batch chunks of at most IM2COL_BYTES of im2col."""
    (kh, kw), (sh, sw), (dh, dw) = kernel_size, stride, dilation
    b, h, w, c = qx.shape
    lh, lw = lhs_dilation
    if lh > 1 or lw > 1:
        spread = qx.new_zeros((b, (h - 1) * lh + 1, (w - 1) * lw + 1, c))
        spread[:, ::lh, ::lw] = qx
        qx = spread
    (ph0, ph1), (pw0, pw1) = pads
    qx = F.pad(qx, (0, 0, pw0, pw1, ph0, ph1))
    ho = (qx.shape[1] - dh * (kh - 1) - 1) // sh + 1
    wo = (qx.shape[2] - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw * c
    k8 = w_mat.shape[1]
    per_image = max(ho * wo * k8, 1)
    chunk = max(1, IM2COL_BYTES // per_image)
    outs = []
    for start in range(0, b, chunk):
        part = qx[start:start + chunk]
        cols = [part[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                     j * dw:j * dw + (wo - 1) * sw + 1:sw]
                for i in range(kh) for j in range(kw)]
        if k8 > k:
            cols.append(part.new_zeros(part.shape[:1] + (ho, wo, k8 - k)))
        a = torch.cat(cols, dim=3).reshape(-1, k8)
        rows = a.shape[0]
        if rows <= 16:  # the card's _int_mm wants more than 16 rows
            a = F.pad(a, (0, 0, 0, 17 - rows))
        MATMULS["int_mm"] += 1
        acc = torch._int_mm(a, w_mat.t())
        outs.append(acc[:rows, :c_out].reshape(part.shape[0], ho, wo, c_out))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


class QuantizedConv(nn.Module):
    """The int8 replacement of one Conv2d / ConvTranspose2d (NCHW in and
    out, in the input's dtype) from its qtable entry."""

    def __init__(self, mod, entry):
        super().__init__()
        w = _to_hwio(mod, entry["w"])
        self.kernel_size = tuple(w.shape[:2])
        self.c_out = int(w.shape[3])
        self.geometry = _geometry(mod)
        self.register_buffer("w_mat", weight_matrix(w))
        x_scale = entry["x_scale"].to(torch.float32)
        self.register_buffer("x_scale", x_scale)
        self.register_buffer("scale", entry["w_scale"].to(torch.float32)
                             * x_scale)
        bias = entry.get("bias") if mod.bias is not None else None
        self.register_buffer("bias", None if bias is None
                             else bias.to(torch.float32))

    def forward(self, x, h_pads=None):
        """`h_pads` (lo, hi), where given, replace the geometry's pads
        along H: a band of rows (parallel/spatial.py) pads only at the
        image's true top and bottom."""
        geometry = self.geometry
        if h_pads is not None:
            geometry = dict(geometry,
                            pads=(tuple(h_pads), geometry["pads"][1]))
        acc = int8_conv(_quantize_input(x, self.x_scale).permute(0, 2, 3, 1),
                        self.w_mat, self.kernel_size, self.c_out, **geometry)
        y = acc.to(torch.float32) * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype).permute(0, 3, 1, 2)


def quantize_model(model: nn.Module, qtable, compute_dtype) -> nn.Module:
    """A copy of `model` in `compute_dtype` whose convs in the qtable
    (and supported: one group, zero padding) run int8; the others stay
    float. The qtable's values may be tensors or numpy arrays
    (models/convert.py `qtable_from_flax`)."""
    qmodel = copy.deepcopy(model).to(compute_dtype).eval()
    for name, entry in qtable.items():
        mod = qmodel.get_submodule(name)
        if not _supported(mod):
            continue
        parent, _, attr = name.rpartition(".")
        setattr(qmodel.get_submodule(parent), attr,
                QuantizedConv(mod, {
                    k: torch.as_tensor(v).to(mod.weight.device)
                    for k, v in entry.items()}))
    return qmodel


# ---------------------------------------------------------------------------
# serving-level composition
# ---------------------------------------------------------------------------

def _calib_bounds(n, calib_batch_size):
    """Calibration chunk starts, equal-size chunks only: the tail chunk
    overlaps the previous one (max-stats are idempotent, every image is
    seen, and no chunk exceeds calib_batch_size)."""
    step = min(int(calib_batch_size or n) or n, n)
    bounds = list(range(0, n - step + 1, step))
    if bounds[-1] + step < n:
        bounds.append(n - step)
    return step, bounds


def quantized_probs_fn(get_model: Callable[[], nn.Module], calib_images,
                       compute_dtype=torch.float32,
                       calib_batch_size: Optional[int] = None,
                       version_fn=None, min_dim: int = 0
                       ) -> Tuple[Callable, Callable]:
    """(probs_fn, get_packed) with int8 convs inside.

    get_model() returns the current float32 serving model (BN-folded where
    the family folds; NCHW in, logits out). calib_images: (N, H, W, 3)
    preprocessed images on the model's device, taken in equal chunks of
    at most calib_batch_size. probs_fn(packed, images) -> (B, H, W, C)
    float32 softmax probabilities; packed = {"module": the quantised
    model wrapped as trainer.SoftmaxProbs, "qtable": its table,
    "seconds": the host seconds its calibration and quantisation took}.

    With `version_fn` (a callable whose value identifies the current
    weights), get_packed() recalibrates when the value drifts: at once by
    default, or after get_packed.set_async(True) on a background thread
    while the previous snapshot serves; the rebuild loops until its key
    matches the live version and swaps atomically under a lock. Without
    it the build-time snapshot serves forever. get_packed.stats holds
    {"recalibrations", "serving_stale_batches"}."""
    n = calib_images.shape[0]
    step, bounds = _calib_bounds(n, calib_batch_size)
    batches = [calib_images[i:i + step] for i in bounds]

    def build():
        start = time.perf_counter()
        model = get_model()
        calib = copy.deepcopy(model).to(compute_dtype).eval()
        stats = collect_stats(calib, batches,
                              forward=SoftmaxProbs(calib, compute_dtype))
        del calib
        qtable = build_qtable(model, stats, min_dim=min_dim)
        module = SoftmaxProbs(quantize_model(model, qtable, compute_dtype),
                              compute_dtype).eval()
        seconds = time.perf_counter() - start
        logger.info("quantized serving: %d conv(s) int8, calibrated on %d "
                    "image(s) in %.3f s", len(qtable), n, seconds)
        return {"module": module, "qtable": qtable, "seconds": seconds}

    cache = {"key": version_fn() if version_fn else None, "packed": build(),
             "rebuilding": False, "async": False}
    lock = threading.Lock()
    stats = {"recalibrations": 0, "serving_stale_batches": 0}

    def _rebuild_loop():
        try:
            while True:
                key = version_fn()  # before the weights are read
                packed = build()
                with lock:
                    cache["packed"] = packed
                    cache["key"] = key
                if version_fn() == key:
                    return
                with lock:
                    stats["recalibrations"] += 1
                logger.info("quantized serving: weights drifted again "
                            "during recalibration; rebuilding")
        finally:
            with lock:
                cache["rebuilding"] = False

    def get_packed():
        if version_fn is not None:
            key = version_fn()
            if key != cache["key"]:
                if cache["async"]:
                    with lock:
                        if key != cache["key"]:
                            stats["serving_stale_batches"] += 1
                            if not cache["rebuilding"]:
                                cache["rebuilding"] = True
                                stats["recalibrations"] += 1
                                logger.info(
                                    "quantized serving: weights changed "
                                    "(%s -> %s); recalibrating in the "
                                    "background, serving the previous "
                                    "snapshot until the swap",
                                    cache["key"], key)
                                threading.Thread(
                                    target=_rebuild_loop, daemon=True,
                                    name="quant-recalibrate").start()
                else:
                    logger.info("quantized serving: weights changed "
                                "(%s -> %s); recalibrating", cache["key"],
                                key)
                    packed = build()
                    with lock:
                        cache["packed"] = packed
                        cache["key"] = key
                        stats["recalibrations"] += 1
        return cache["packed"]

    def set_async(flag: bool):
        """Serve the previous snapshot during a drift rebuild instead of
        blocking the caller (the daemon's mode)."""
        cache["async"] = bool(flag)

    get_packed.set_async = set_async
    get_packed.stats = stats

    def probs_fn(packed, images):
        return packed["module"](images)

    return probs_fn, get_packed


class QuantizedProbs:
    """images -> probabilities through the current int8 snapshot of a
    (probs_fn, get_packed) pair, with the pair's `set_async` and `stats`:
    the probability function of a quantised FusedServe. It runs on the
    images' device: the snapshot's int8 model is copied once to each
    other device it meets (parallel/mesh.py `Replicas`; a recalibration's
    new snapshot drops the copies), as the JAX package replicates the
    packed pytree over a mesh."""

    def __init__(self, probs_fn, get_packed):
        self.probs_fn = probs_fn
        self.get_packed = get_packed
        self.set_async = get_packed.set_async
        self.stats = get_packed.stats
        self._replicas = Replicas()

    def __call__(self, images):
        packed = self.get_packed()
        module = self._replicas.get(packed["module"], images.device)
        if module is not packed["module"]:
            packed = dict(packed, module=module)
        with torch.inference_mode():
            return self.probs_fn(packed, images)

    def module(self) -> nn.Module:
        """The current snapshot's module, for export."""
        return self.get_packed()["module"]
