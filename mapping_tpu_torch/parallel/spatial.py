"""Spatial partitioning: one image's rows split over the devices of a mesh.

Counterpart of the JAX package's height sharding (`P(None, 'data')` in
mapping_tpu/infer/sharded.py `make_spatial_infer` and infer/serving.py
`_spatial_program`), where GSPMD inserts the halo exchange every conv
needs. In the port the exchange is explicit:

- Row ownership (`band_rows`): of a map of height h, band i of n owns the
  rows [floor(i h / n), floor((i + 1) h / n)). The rule depends on h and n
  only, so two maps of one level share a partition, and a skip concat, an
  add or any elementwise op maps band by band. A band may own no rows at
  the coarse levels; nothing asks a band to be a multiple of the model's
  stride.
- A spatial layer computes its band's own output rows. It first fetches
  the input rows they read from whichever bands own them (`_fetch`:
  `Tensor.to(device, non_blocking=True)` of those rows only, a peer copy
  across cards, none when two bands share a card; never a whole map), and
  applies the layer's own edge rule at the image's true top and bottom
  only: zero rows for a conv (float or int8), -inf rows for a max pool,
  the clamp of the half-pixel bilinear 2x upsample (the fetched rows stop
  at the edge, where the op clamps itself), and for a transposed conv the
  crop of the full output. A stride-2 layer whose band starts on an odd
  row just fetches from there. The W axis is not split.
- `SpatialProgram` runs a forward band by band: a torch.fx trace of the
  function (in eval mode), interpreted with each node's value the list of
  its per-band tensors. Conv2d, ConvTranspose2d, MaxPool2d, the int8
  QuantizedConv and F.interpolate (bilinear 2x) run through the exchange;
  every other node must be row-local (elementwise or channel-wise, or a
  permute, softmax, concat, stack or index off the row axis) and maps over
  the bands, or the program raises: there is no fallback. Each device runs
  its own copy of the traced module (`Replicas`), and one host thread
  enqueues every band, layer by layer.
- `gather_resized` resizes each band's probabilities toward the target
  size, W first (band-local), then H as the band's partial: the columns of
  the H resize matrix (data/augment.resize_matrix) of its source rows. The
  partials are summed on the first device, so the gather moves (B, th, tw,
  C) maps, never the full-resolution one.

`EXCHANGE` counts what moves between bands: the halo rows, the gathered
partials, and the rows of the largest single transfer.
"""

import inspect
import math
import operator
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import fx, nn

from mapping_tpu_torch.data.augment import resize_matrix
from mapping_tpu_torch.models.quantize import QuantizedConv
from mapping_tpu_torch.parallel.mesh import Replicas
from mapping_tpu_torch.train.step import _no_tf32


def band_rows(h: int, n: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of n bands of a map of height h."""
    return [(i * h // n, (i + 1) * h // n) for i in range(n)]


class Exchange:
    """What moved between bands since `reset()`: bytes of halo rows
    fetched from another band's device (`halo_bytes`) and of partial maps
    gathered on the first device (`gather_bytes`), the number of
    transfers, and the rows and bytes of the largest single transfer."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.halo_bytes = self.gather_bytes = self.transfers = 0
        self.max_rows = self.max_bytes = 0

    def as_dict(self):
        return dict(halo_bytes=self.halo_bytes,
                    gather_bytes=self.gather_bytes,
                    transfers=self.transfers, max_rows=self.max_rows,
                    max_bytes=self.max_bytes)

    def move(self, t: torch.Tensor, device, rows: int, gather=False):
        size = t.numel() * t.element_size()
        if gather:
            self.gather_bytes += size
        else:
            self.halo_bytes += size
        self.transfers += 1
        self.max_rows = max(self.max_rows, rows)
        self.max_bytes = max(self.max_bytes, size)
        return t.to(device, non_blocking=True)


EXCHANGE = Exchange()


class Banded:
    """A map split into bands of rows: parts[i] holds band i's rows
    (`band_rows(h, n)[i]`) along dimension `axis`."""

    __slots__ = ("parts", "axis", "h")

    def __init__(self, parts, axis: int, h: int):
        self.parts, self.axis, self.h = list(parts), axis, h


class PerBand(list):
    """A value with one copy per band (a parameter on each band's device),
    not split into rows."""


def split_rows(images: torch.Tensor, devices) -> Banded:
    """(B, H, ...) -> its bands of rows, band i on devices[i]."""
    h = images.shape[1]
    return Banded([images.narrow(1, r0, r1 - r0).to(d, non_blocking=True)
                   for (r0, r1), d in zip(band_rows(h, len(devices)),
                                          devices)], 1, h)


def _fetch(x: Banded, i: int, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) (within [0, h)) of `x` on band i's device; only the
    rows other bands own are copied."""
    pieces = []
    for j, (r0, r1) in enumerate(band_rows(x.h, len(x.parts))):
        a, b = max(lo, r0), min(hi, r1)
        if a < b:
            piece = x.parts[j].narrow(x.axis, a - r0, b - a)
            if j != i:
                piece = EXCHANGE.move(piece, device, b - a)
            pieces.append(piece)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, x.axis)


# ---------------------------------------------------------------------------
# spatial layers
# ---------------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _Window:
    """The H geometry of a correlation: kernel k, stride s, dilation d,
    input dilation ld (a transposed conv's stride), pads lo and hi."""

    def __init__(self, k, s, d, ld, lo, hi):
        self.k, self.s, self.d, self.ld, self.lo, self.hi = k, s, d, ld, lo, hi

    def out_rows(self, h: int) -> int:
        padded = self.lo + (h - 1) * self.ld + 1 + self.hi
        return (padded - self.d * (self.k - 1) - 1) // self.s + 1

    def reads(self, h: int, o0: int, o1: int):
        """Output rows [o0, o1) read the input rows [ia, ib); the rows of
        padding (or of the dilation's gaps) above and below those are
        (pad_lo, pad_hi)."""
        p0 = o0 * self.s
        p1 = (o1 - 1) * self.s + self.d * (self.k - 1)
        ia = max(0, -(-(p0 - self.lo) // self.ld))
        ib = min(h, (p1 - self.lo) // self.ld + 1)
        if ib <= ia:
            raise ValueError(f"output rows [{o0}, {o1}) read no input row")
        return (ia, ib, self.lo + ia * self.ld - p0,
                p1 - (self.lo + (ib - 1) * self.ld))


def _conv_pads(mod) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if isinstance(mod.padding, str):
        totals = [d * (k - 1) if mod.padding == "same" else 0
                  for k, d in zip(mod.kernel_size, mod.dilation)]
        return tuple((t // 2, t - t // 2) for t in totals)
    return tuple((p, p) for p in mod.padding)


def _conv(mod: nn.Conv2d):
    if mod.padding_mode != "zeros":
        raise NotImplementedError(f"spatial serving: {mod} pads with "
                                  f"{mod.padding_mode!r}, not zeros")
    (lo, hi), (wlo, whi) = _conv_pads(mod)
    window = _Window(mod.kernel_size[0], mod.stride[0], mod.dilation[0], 1,
                     lo, hi)

    uneven = wlo != whi  # "same" with an even kernel: torch pads W first

    def band(m, x, i, o0, o1, device):
        ia, ib, pad_lo, pad_hi = window.reads(x.h, o0, o1)
        slab = _fetch(x, i, ia, ib, device)
        if pad_lo or pad_hi or uneven:
            slab = F.pad(slab, ((wlo, whi) if uneven else (0, 0))
                         + (pad_lo, pad_hi))
        return F.conv2d(slab, m.weight, m.bias, m.stride,
                        (0, 0 if uneven else wlo), m.dilation, m.groups)

    return window.out_rows, band


def _max_pool(mod: nn.MaxPool2d):
    if mod.ceil_mode or mod.return_indices:
        raise NotImplementedError(f"spatial serving: {mod} (ceil_mode or "
                                  f"return_indices)")
    k, s, p, d = (_pair(v) for v in (mod.kernel_size, mod.stride or
                                     mod.kernel_size, mod.padding,
                                     mod.dilation))
    window = _Window(k[0], s[0], d[0], 1, p[0], p[0])

    def band(m, x, i, o0, o1, device):
        ia, ib, pad_lo, pad_hi = window.reads(x.h, o0, o1)
        slab = _fetch(x, i, ia, ib, device)
        if pad_lo or pad_hi:
            slab = F.pad(slab, (0, 0, pad_lo, pad_hi), value=-math.inf)
        return F.max_pool2d(slab, k, s, (0, p[1]), d)

    return window.out_rows, band


def _conv_transpose(mod: nn.ConvTranspose2d):
    if mod.padding_mode != "zeros":
        raise NotImplementedError(f"spatial serving: {mod} pads with "
                                  f"{mod.padding_mode!r}")
    k, s, d = mod.kernel_size[0], mod.stride[0], mod.dilation[0]
    p, op = mod.padding[0], mod.output_padding[0]
    window = _Window(k, 1, d, s, d * (k - 1) - p, d * (k - 1) - p + op)

    def band(m, x, i, o0, o1, device):
        ia, ib, _, _ = window.reads(x.h, o0, o1)
        full = F.conv_transpose2d(
            _fetch(x, i, ia, ib, device), m.weight, m.bias, m.stride,
            (0, m.padding[1]), (0, m.output_padding[1]), m.groups,
            m.dilation)
        top = o0 + p - ia * s
        if top < 0 or top + o1 - o0 > full.shape[2]:
            raise NotImplementedError(f"spatial serving: {mod} (the band's "
                                      f"rows leave its full output)")
        return full.narrow(2, top, o1 - o0)

    return window.out_rows, band


def _quantized_conv(mod: QuantizedConv):
    g = mod.geometry
    (lo, hi) = g["pads"][0]
    window = _Window(mod.kernel_size[0], g["stride"][0], g["dilation"][0],
                     g["lhs_dilation"][0], lo, hi)

    def band(m, x, i, o0, o1, device):
        ia, ib, pad_lo, pad_hi = window.reads(x.h, o0, o1)
        return m(_fetch(x, i, ia, ib, device), h_pads=(pad_lo, pad_hi))

    return window.out_rows, band


_INTERPOLATE = inspect.signature(F.interpolate)


def _upsample(args, kwargs):
    """F.interpolate's bilinear 2x (half-pixel; blocks.upsample2x): the
    band's output rows [o0, o1) read input rows o0 // 2 - 1 to
    (o1 - 1) // 2 + 1, clamped at the image's edges by the op itself."""
    bound = _INTERPOLATE.bind(*args, **kwargs)
    bound.apply_defaults()
    a = bound.arguments
    scale = a["scale_factor"]
    if not (a["size"] is None and a["mode"] == "bilinear"
            and not a["align_corners"] and not a["antialias"]
            and not a["recompute_scale_factor"]
            and all(float(v) == 2.0 for v in _pair(scale))):
        raise NotImplementedError(f"spatial serving: F.interpolate with "
                                  f"{dict(a, input=None)}")
    rest = {k: v for k, v in a.items() if k != "input"}

    def band(_, x, i, o0, o1, device):
        lo, hi = max(0, o0 // 2 - 1), min(x.h, (o1 - 1) // 2 + 2)
        out = F.interpolate(_fetch(x, i, lo, hi, device), **rest)
        return out.narrow(2, o0 - 2 * lo, o1 - o0)

    return (lambda h: 2 * h), band


_SPATIAL_MODULES = ((nn.Conv2d, _conv),
                    (nn.ConvTranspose2d, _conv_transpose),
                    (nn.MaxPool2d, _max_pool),
                    (QuantizedConv, _quantized_conv))


def _spatial_layer(x: Banded, out_rows: Callable, band, mods, devices):
    if x.axis != 2:
        raise NotImplementedError(f"spatial serving: a spatial layer on "
                                  f"rows along dimension {x.axis}, not 2")
    h_out = out_rows(x.h)
    bounds = band_rows(h_out, len(devices))
    parts = [band(m, x, i, o0, o1, d) if o1 > o0 else None
             for i, (m, (o0, o1), d) in enumerate(zip(mods, bounds, devices))]
    ref = next(p for p in parts if p is not None)
    for i, d in enumerate(devices):
        if parts[i] is None:  # a band of no rows
            shape = list(ref.shape)
            shape[2] = 0
            parts[i] = torch.empty(shape, dtype=ref.dtype, device=d)
    return Banded(parts, 2, h_out)


# ---------------------------------------------------------------------------
# row-local nodes
# ---------------------------------------------------------------------------

#: the row-local ops of the port's forwards (every family, the int8 one)
#: and of the probability functions of the tests
_ELEMENTWISE_FUNCTIONS = {operator.add, operator.mul, operator.truediv,
                          operator.neg, torch.relu, F.relu}
_ELEMENTWISE_METHODS = {"to", "float"}
_ELEMENTWISE_MODULES = (nn.ReLU, nn.Identity)


def _pick(value, i):
    if isinstance(value, Banded):
        return value.parts[i]
    if isinstance(value, PerBand):
        return value[i]
    if isinstance(value, (list, tuple)):
        return type(value)(_pick(v, i) for v in value)
    if isinstance(value, dict):
        return {k: _pick(v, i) for k, v in value.items()}
    return value


def _banded_inputs(args, kwargs) -> List[Banded]:
    found = []

    def visit(v):
        if isinstance(v, Banded):
            found.append(v)
        elif isinstance(v, (list, tuple)):
            for u in v:
                visit(u)
        elif isinstance(v, dict):
            for u in v.values():
                visit(u)

    visit(args)
    visit(kwargs)
    return found


def _row_axis(kind, args, kwargs, x: Banded, out0):
    """The row axis of the result of a row-local node on band 0 (`out0`),
    or raise where the node reads along the rows."""
    ndim = x.parts[0].dim()
    if kind == "permute":
        dims = args[1] if isinstance(args[1], (tuple, list)) else args[1:]
        return [d % ndim for d in dims].index(x.axis)
    if kind == "softmax":
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        if dim is None or dim % ndim == x.axis:
            raise NotImplementedError("spatial serving: a softmax over the "
                                      "rows")
        return x.axis
    if kind == "cat":
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        if dim % ndim == x.axis:
            raise NotImplementedError("spatial serving: a concat along the "
                                      "rows")
        return x.axis
    if kind == "stack":
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0) % (ndim + 1)
        return x.axis + (1 if dim <= x.axis else 0)
    if kind == "getitem":
        index = args[1] if isinstance(args[1], tuple) else (args[1],)
        if index[:1] != (Ellipsis,) or Ellipsis in index[1:] or \
                len(index) - 1 > ndim - 1 - x.axis or any(
                    v is None for v in index):
            raise NotImplementedError(f"spatial serving: indexing {index} "
                                      f"reaches the rows")
        return x.axis
    # elementwise: broadcasting aligns the trailing dimensions
    return x.axis + out0.dim() - ndim


def _classify(node: fx.Node, module) -> str:
    target = node.target
    if node.op == "call_module":
        if isinstance(module, nn.modules.batchnorm._BatchNorm):
            if module.training:
                raise NotImplementedError(f"spatial serving: {module} in "
                                          f"training mode")
            return "elementwise"
        if isinstance(module, _ELEMENTWISE_MODULES):
            return "elementwise"
    elif node.op == "call_function":
        if target in _ELEMENTWISE_FUNCTIONS:
            return "elementwise"
        kinds = {torch.softmax: "softmax", torch.cat: "cat",
                 torch.stack: "stack", operator.getitem: "getitem"}
        if target in kinds:
            return kinds[target]
    elif node.op == "call_method":
        if target in _ELEMENTWISE_METHODS:
            return "elementwise"
        if target == "permute":
            return target
    raise NotImplementedError(
        f"spatial serving: {node.op} {getattr(target, '__name__', target)!r}"
        f" ({node.format_node()}) is not row-local and has no band rule")


# ---------------------------------------------------------------------------
# the band executor
# ---------------------------------------------------------------------------

class _Tracer(fx.Tracer):
    def is_leaf_module(self, m, qualname):
        return isinstance(m, (QuantizedConv, nn.modules.batchnorm._BatchNorm)
                          ) or super().is_leaf_module(m, qualname)


class _Function(nn.Module):
    """A plain function as the root of a trace."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, images):
        return self.fn(images)


class SpatialProgram:
    """`fn` (images (B, H, W, ...) -> a map with the same rows, e.g. the
    (B, H, W, C) probabilities of trainer.SoftmaxProbs) run band by band:
    `program(images, devices)` -> a Banded output, band i of the rows on
    devices[i]. `fn` is traced once; it must be a module in eval mode or
    a function of one tensor."""

    def __init__(self, fn: Callable):
        self.source = fn
        root = fn if isinstance(fn, nn.Module) else _Function(fn)
        self.module = fx.GraphModule(root, _Tracer().trace(root))
        # the trace ran SoftmaxProbs' TF32 scope once; runs re-enter it
        self.float32 = getattr(fn, "compute_dtype", None) == torch.float32
        self._replicas = Replicas()
        self._bound = {}
        nodes = list(self.module.graph.nodes)
        last = {}
        for k, node in enumerate(nodes):
            for inp in node.all_input_nodes:
                last[inp] = k
        self._steps = [(node, [m for m in node.all_input_nodes
                               if last[m] == k])
                       for k, node in enumerate(nodes)]
        self._kinds = {}
        for node in nodes:
            if node.op == "call_module":
                mod = self.module.get_submodule(node.target)
                rule = next((f for t, f in _SPATIAL_MODULES
                             if isinstance(mod, t)), None)
                self._kinds[node] = (("spatial", rule(mod)) if rule
                                     else (_classify(node, mod), None))
            elif node.op == "call_function" and node.target is F.interpolate:
                self._kinds[node] = ("interpolate", None)
            elif node.op in ("call_function", "call_method"):
                self._kinds[node] = (_classify(node, None), None)

    def _bind(self, devices):
        """{node: its module or attribute on each band's device}, made
        once per device list (a copy of the module per device)."""
        key = tuple(devices)
        if key not in self._bound:
            replicas = [self._replicas.get(self.module, d) for d in devices]
            self._bound[key] = {
                node: PerBand(r.get_submodule(node.target)
                              if node.op == "call_module"
                              else _attr(r, node.target) for r in replicas)
                for node, _ in self._steps
                if node.op in ("call_module", "get_attr")}
        return self._bound[key]

    def __call__(self, images: torch.Tensor, devices: Sequence) -> Banded:
        devices = [torch.device(d) for d in devices]
        bound = self._bind(devices)
        env = {}
        with _no_tf32(self.float32):
            for node, done in self._steps:
                if node.op == "placeholder":
                    env[node] = split_rows(images, devices)
                elif node.op == "output":
                    out = env[node.args[0]]
                    if not isinstance(out, Banded):
                        raise NotImplementedError("spatial serving: the "
                                                  "output is not a map")
                    return out
                else:
                    env[node] = self._run(node, env, bound, devices)
                for m in done:
                    del env[m]
        raise AssertionError("the graph has no output")

    def _run(self, node, env, bound, devices):
        if node.op == "get_attr":
            return bound[node]
        args = fx.node.map_arg(node.args, env.__getitem__)
        kwargs = fx.node.map_arg(node.kwargs, env.__getitem__)
        kind, rule = self._kinds[node]
        mods = bound.get(node)
        if kind == "spatial":
            return _spatial_layer(args[0], *rule, mods, devices)
        if kind == "interpolate":
            return _spatial_layer(args[0], *_upsample(args, kwargs),
                                  [None] * len(devices), devices)
        banded = _banded_inputs(args, kwargs)
        if not banded:
            raise NotImplementedError(f"spatial serving: {node.format_node()}"
                                      f" computes on no map")
        x = banded[0]
        if any(b.h != x.h for b in banded):
            raise NotImplementedError("spatial serving: maps of different "
                                      "heights meet")
        outs = []
        for i in range(len(devices)):
            a, k = _pick(args, i), _pick(kwargs, i)
            if node.op == "call_module":
                outs.append(mods[i](*a, **k))
            elif node.op == "call_method":
                outs.append(getattr(a[0], node.target)(*a[1:], **k))
            else:
                outs.append(node.target(*a, **k))
        axis = _row_axis(kind, args, kwargs, x, outs[0])
        if kind == "elementwise":
            for b in banded:
                if b.axis + outs[0].dim() - b.parts[0].dim() != axis:
                    raise NotImplementedError("spatial serving: maps whose "
                                              "rows do not align")
            for i in range(len(devices)):
                _check_operands(args, kwargs, axis, outs[i].dim(), i)
        return Banded(outs, axis, x.h)


def _attr(module, target: str):
    obj = module
    for name in target.split("."):
        obj = getattr(obj, name)
    return obj


def _check_operands(args, kwargs, axis, ndim, i):
    """An operand not split into rows may meet a band only where it
    broadcasts along the rows (a bias, a per-channel scale)."""
    def visit(v):
        if isinstance(v, PerBand):
            v = v[i]
        if isinstance(v, torch.Tensor):
            pos = v.dim() - (ndim - axis)
            if pos >= 0 and v.shape[pos] != 1:
                raise NotImplementedError("spatial serving: an operand of "
                                          "full height meets a band")
        elif isinstance(v, (list, tuple)):
            for u in v:
                visit(u)
        elif isinstance(v, dict):
            for u in v.values():
                visit(u)

    visit(args)
    visit(kwargs)


# ---------------------------------------------------------------------------
# resize and gather
# ---------------------------------------------------------------------------

_MATRICES = {}


def _matrix(n_in, n_out, antialias, dtype, device):
    key = (n_in, n_out, antialias, dtype, device)
    if key not in _MATRICES:
        _MATRICES[key] = resize_matrix(n_in, n_out, antialias, dtype,
                                       device)
    return _MATRICES[key]


def crop_bands(probs: Banded, crop_size=None
               ) -> Tuple[int, List[Tuple[int, torch.Tensor]]]:
    """(height, [(row offset, rows), ...]) of the bands of NHWC `probs`
    inside the centred `crop_size` window (infer/serving.ServeProgram's
    crop), offsets from the window's top; the whole map without a
    `crop_size`. Bands of no rows there are left out."""
    bounds = band_rows(probs.h, len(probs.parts))
    w = probs.parts[0].shape[2]
    ch, cw = crop_size or (probs.h, w)
    top, left = (probs.h - ch) // 2, (w - cw) // 2
    out = []
    for (r0, r1), p in zip(bounds, probs.parts):
        a, b = max(r0, top), min(r1, top + ch)
        if a < b:
            out.append((a - top, p[:, a - r0:b - r0, left:left + cw]))
    return ch, out


def gather_resized(h: int, pieces: Sequence[Tuple[int, torch.Tensor]],
                   target_size: Tuple[int, int], device) -> torch.Tensor:
    """The (B, th, tw, C) resize of the NHWC map of height h whose rows
    are `pieces` ((row offset, rows) on their devices; `crop_bands`), as
    resize_bilinear computes it, summed on `device`: each band resizes W,
    then takes its H partial, and only the partials move there."""
    th, tw = target_size
    w = pieces[0][1].shape[2]
    antialias = th < h or tw < w  # resize_bilinear's one decision
    device = torch.device(device)
    total = None
    with _no_tf32(True):
        for start, part in pieces:
            if w != tw:
                part = torch.einsum("bhwc,tw->bhtc", part, _matrix(
                    w, tw, antialias, part.dtype, part.device))
            rh = _matrix(h, th, antialias, part.dtype, part.device)
            partial = torch.einsum("sh,bhtc->bstc",
                                   rh[:, start:start + part.shape[1]], part)
            if total is not None:
                partial = EXCHANGE.move(partial, device, th, gather=True)
            total = partial if total is None else total + partial
    return total
