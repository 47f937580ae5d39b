"""DecoderCore: wires the native syntax front end to a pixel backend.

Port of the JAX package's `core.py`.  The front end (native/) parses NALs
into per-slot syntax planes and emits events; this core reacts to them:

  EV_FORMAT      (re)size the frame store
  EV_FRAME_DONE  run the pixel backend on the slot's planes -> YUV
  EV_UNPIN       drop the slot's frame (and its reference ring entry)

A backend has one method, `reconstruct(planes, slot, store[, is_ref]) ->
(y, cb, cr)`, and optionally `unpin(slot)`.  The port's backends:
  "torch"  the default: ops/backend.TorchBackend, on `device` (cuda
           unless the caller passes "cpu")
  "numpy"  NumpyBackend, the scalar oracle (ops/oracle.py,
           ops/deblock_oracle.py) on the host; `device` is ignored
A backend instance may be passed instead.  Frames reach the host only in
get_frame.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from .api import Frame
from .native import EV_FORMAT, EV_FRAME_DONE, EV_UNPIN, NativeDecoder

# the JAX package's other backend, not in the port
_NOT_PORTED = {"jax": "the port never runs JAX; the JAX package's own "
                      "Decoder is that backend (ROADMAP.md, north star)"}


def _host(a):
    """A frame plane as a host numpy array (a device tensor is copied)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class FrameStore:
    """Decoded YUV planes per DPB slot (device tensors for the torch
    backend: the frames stay on the device until get_frame)."""

    def __init__(self):
        self.frames = {}          # slot -> (y, cb, cr)

    def put(self, slot, y, cb, cr):
        self.frames[slot] = (y, cb, cr)

    def get(self, slot):
        return self.frames.get(slot)

    def drop(self, slot):
        self.frames.pop(slot, None)

    def clear(self):
        self.frames.clear()


class NumpyBackend:
    """Bit-exact scalar model on the host, the golden that shares no code
    with the port's tensor code (the JAX package's `core.NumpyBackend`).
    Frames are host numpy arrays; references come from the frame store."""

    def __init__(self):
        from .ops import deblock_oracle, oracle
        from .ops.batched import scaling8
        self.oracle = oracle
        self.deblock = deblock_oracle
        self.scaling8 = scaling8

    def reconstruct(self, planes, slot, store):
        sm = self.oracle.ScalingMatrices(ws4=np.asarray(planes.sm4),
                                         ws8=self.scaling8(planes.sm8))
        y, cb, cr = self.oracle.reconstruct_frame(planes, sm, store.frames)
        self.deblock.deblock_frame(planes, y, cb, cr)
        self.deblock.blend_recovered_frame(planes, y, cb, cr)
        return y, cb, cr


class DecoderCore:
    def __init__(self, log_cb=None, log_mbs=False, device=None,
                 backend="torch", n_tasks: int = 0):
        if not isinstance(backend, str):
            self._backend = backend       # custom backend instance
        elif backend == "torch":
            from .ops.backend import TorchBackend
            self._backend = TorchBackend(device=device)
        elif backend == "numpy":
            self._backend = NumpyBackend()
        elif backend in _NOT_PORTED:
            raise ValueError(f"backend {backend!r} is not ported: "
                             f"{_NOT_PORTED[backend]}")
        else:
            raise ValueError(f"unknown backend {backend!r}")
        # frame-task workers and YAML logging are mutually exclusive (the
        # native layer stays synchronous while logging)
        self._nd = NativeDecoder(log=log_cb is not None, log_mbs=log_mbs,
                                 n_tasks=n_tasks)
        self._log_cb = log_cb
        self._store = FrameStore()
        self._errors = {}         # slot -> mb_errors plane (or None)
        self._fmt = None
        # probe is_ref support once: a per-frame `except TypeError` around
        # reconstruct would swallow TypeErrors raised INSIDE it
        params = inspect.signature(self._backend.reconstruct).parameters
        self._backend_is_ref = "is_ref" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())

    # -- event pump --------------------------------------------------------
    def _handle(self, events):
        for kind, slot, _a, b, _c, _d in events:
            if kind == EV_FORMAT:
                self._fmt = self._nd.format()
                self._store.clear()
            elif kind == EV_FRAME_DONE:
                planes = self._nd.planes(slot)
                kw = {"is_ref": bool(b)} if self._backend_is_ref else {}
                y, cb, cr = self._backend.reconstruct(planes, slot,
                                                      self._store, **kw)
                self._store.put(slot, y, cb, cr)
                errs = np.asarray(planes.mb_errors)
                self._errors[slot] = errs.copy() if errs.any() else None
            elif kind == EV_UNPIN:
                self._store.drop(slot)
                if hasattr(self._backend, "unpin"):
                    self._backend.unpin(slot)
        if self._log_cb is not None:
            log = self._nd.get_log()
            if log:
                self._log_cb(log)

    def decode_nal(self, buf) -> int:
        data = bytes(buf) if buf else b""
        ret, events = self._nd.decode_nal(data)
        self._handle(events)
        return ret

    def wait_frame(self) -> int:
        """Block until the oldest queued output frame completes (frame-task
        mode); then drain the retirement events so its planes reconstruct."""
        r = self._nd.wait_frame()
        self._handle(self._nd.poll())
        return r

    def get_frame(self, borrow: bool = False) -> Frame | None:
        # worker tasks may have retired frames since the last decode_nal:
        # drain their events first so the store holds the planes
        self._handle(self._nd.poll())
        info = self._nd.get_frame(borrow=borrow)
        if info is None:
            return None
        fmt = self._fmt or self._nd.format()
        slot = info["slot"]
        planes = self._store.get(slot)
        if planes is None:            # frame had no parsed mbs
            return None
        ct, cr_, cb_, cl = (fmt["crop_top"], fmt["crop_right"],
                            fmt["crop_bottom"], fmt["crop_left"])
        wY, hY = fmt["mb_w"] * 16, fmt["mb_h"] * 16

        def crop(yuv):
            y, cb, cr = (_host(a) for a in yuv)
            return (y[ct:hY - cb_, cl:wY - cr_],
                    cb[ct // 2:(hY - cb_) // 2, cl // 2:(wY - cr_) // 2],
                    cr[ct // 2:(hY - cb_) // 2, cl // 2:(wY - cr_) // 2])

        y, cb, cr = crop(planes)
        f = Frame(y=y, cb=cb, cr=cr, frame_id=info["frame_id"],
                  mb_errors=self._errors.get(slot),
                  crop_offsets=(ct, cr_, cb_, cl),
                  timing=(fmt.get("num_units_in_tick", 0),
                          fmt.get("time_scale", 0)),
                  return_arg=slot)
        mslot = info["slot_mvc"]
        if mslot >= 0:
            f.return_arg = (slot, mslot)   # return both views' borrows
            mp = self._store.get(mslot)
            if mp is not None:
                f.y_mvc, f.cb_mvc, f.cr_mvc = crop(mp)
                f.frame_id_mvc = info["frame_id_mvc"]
        return f

    def return_frame(self, frame: Frame) -> None:
        """Release a borrowed frame's DPB slot(s) (after
        get_frame(borrow=True)); borrowed slots count toward the 32-slot
        ENOBUFS backpressure until returned."""
        arg = frame.return_arg
        if arg is None:
            return
        for s in arg if isinstance(arg, tuple) else (arg,):
            if s is not None and s >= 0:
                self._nd.return_frame(s)

    def flush(self) -> None:
        self._nd.flush()
        self._store.clear()

    def close(self) -> None:
        self._nd.close()
