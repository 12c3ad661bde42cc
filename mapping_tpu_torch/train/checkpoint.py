"""Checkpoints: the port's own transformer cache and resume files,
reference torch checkpoints, and the JAX package's flax msgpack files.

Counterpart of mapping_tpu/train/checkpoint.py and
mapping_tpu/models/torch_convert.py `load_torch_file`:
- the port's cache `unet.pt` and best weights `best.pt` are torch.save of
  the model's reference-named state_dict (weights and BatchNorm
  statistics), written atomically;
- the port's resume file `last.pt` holds the whole training state
  (`save_train_state`): the model's state_dict, `optimizer.state_dict()`
  (Adam's moments and step counts), the schedule's state_dict (StepLR's
  `last_epoch` counts optimizer steps), the optimizer step count, and the
  resume sidecar's dict, so that the epoch schedule and the state it
  belongs to are renamed into place together. Every leaf is a tensor or a
  plain Python value: `torch.load(weights_only=True)` reads it back;
- `load_weights` reads the weights alone of a cache, a best file or a
  resume file (warm start);
- the port resumes only from its own `last.pt`. The JAX package's resume
  file `last.msgpack` holds optax's state tree, which has no one-to-one
  map onto torch's Adam state without the JAX package's tree structure, so
  a checkpoint dir that holds one is refused (`refuse_jax_resume_file`)
  rather than resumed from or silently ignored: a run would otherwise
  start its schedule again over a JAX run's epochs. The JAX package's
  *weights* (`unet.msgpack`) are read, for serving and for warm start;
- a reference checkpoint is a torch state_dict: plain, wrapped as
  {"state_dict": ...}, or with nn.DataParallel's "module." prefix; a
  `.npz` of the same names is read too (pretrained encoder files);
- a JAX experiment's `unet.msgpack` is flax.serialization's msgpack of
  {params, batch_stats, opt_state, step}. `msgpack_restore` reads it with
  the standard library: the msgpack formats, ext type 1 (an ndarray,
  payload msgpack (shape, dtype name, C-order bytes)) and ext type 3 (a
  numpy scalar, same payload). Arrays flax split into chunks
  (`__msgpack_chunked_array__`, leaves over 1 GiB) raise.
"""

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# msgpack, the subset flax writes
# ---------------------------------------------------------------------------


def _bfloat16_to_float32(raw: bytes) -> np.ndarray:
    bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, raw = _Reader(payload, raw_strings=True).read_all()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        flat = _bfloat16_to_float32(raw)
    else:
        flat = np.frombuffer(raw, dtype=np.dtype(dtype))
    return flat.reshape(shape, order="C")


class _Reader:
    """Decoder of one msgpack object. `raw_strings` keeps str payloads
    as bytes (flax reads an ndarray's payload so)."""

    def __init__(self, data: bytes, raw_strings: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw_strings

    def _take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read_all(self):
        out = self.read()
        if self.pos != len(self.data):
            raise ValueError("extra bytes after the msgpack object")
        return out

    def _str(self, n):
        raw = bytes(self._take(n))
        return raw if self.raw else raw.decode("utf-8")

    def _ext(self, code, n):
        payload = bytes(self._take(n))
        if code == 1:
            return _ndarray(payload)
        if code == 3:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8/16/32
        if b in ext:
            n = self._unpack(ext[b])
            return self._ext(self._unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        strings = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strings:
            return self._str(self._unpack(strings[b]))
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without flax or msgpack: the
    nested dicts and lists of the file, arrays as numpy arrays (bfloat16
    widened to float32) and numpy scalars as numpy scalars."""
    tree = _Reader(data).read_all()

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("the checkpoint holds an array over 1 GiB, "
                                 "which flax writes in chunks; not supported")
            for v in node.values():
                check(v)

    check(tree)
    return tree


def load_flax_weights(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) of a flax msgpack checkpoint (a JAX
    experiment's transformer cache or a weights-only file)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    return tree["params"], tree.get("batch_stats", {})


# ---------------------------------------------------------------------------
# torch state dicts
# ---------------------------------------------------------------------------

def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """A reference checkpoint: a plain state_dict, {"state_dict": ...},
    or "module."-prefixed keys, or a .npz of such names -> {name: CPU
    tensor}."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            state = {k: torch.from_numpy(f[k]) for k in f.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k):
            torch.as_tensor(v) for k, v in state.items()}


def _save_atomic(payload, path):
    """torch.save to a temporary file renamed over `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_state_dict(state: Dict[str, torch.Tensor], path):
    """torch.save of `state` (moved to the CPU), written to a temporary
    file and renamed over `path`."""
    _save_atomic({k: v.detach().cpu() for k, v in state.items()}, path)


def save_train_state(path, model_state, optimizer_state, scheduler_state,
                     step: int, aux: Dict[str, Any]):
    """The resume file: the whole training state and the sidecar's dict
    in one atomically written torch.save."""
    _save_atomic({"model": {k: v.detach().cpu()
                            for k, v in model_state.items()},
                  "optimizer": optimizer_state, "scheduler": scheduler_state,
                  "step": int(step), "aux": aux}, path)


def load_train_state(path) -> Dict[str, Any]:
    """The dict `save_train_state` wrote, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(path) -> Dict[str, torch.Tensor]:
    """The model's state_dict of a port cache, best file or resume
    file."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["model"] if "optimizer" in state else state


def refuse_jax_resume_file(checkpoint_dir):
    """Raise if `checkpoint_dir` holds the JAX package's resume file."""
    path = os.path.join(checkpoint_dir, "last.msgpack")
    if os.path.exists(path):
        raise RuntimeError(
            f"{path} is a resume file of the JAX package; the PyTorch port "
            f"resumes only from its own last.pt and does not read optax "
            f"state. Train this experiment on with the JAX package, or "
            f"move {path} away to start the port's own schedule (its "
            f"weights can seed one: `train -w` reads the experiment's "
            f"unet.msgpack).")
