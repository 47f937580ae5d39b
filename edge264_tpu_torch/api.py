"""Public decoder API: the port's copy of the JAX package's `api.py`.

  Decoder(...)            streaming decoder (edge264_alloc)
  Decoder.decode_nal(buf) -> errno int (edge264_decode_NAL)
  Decoder.get_frame()     -> Frame | None (edge264_get_frame)
  Decoder.return_frame(f), flush(), close()
  decode_annexb(stream)   all Frames of an Annex-B stream, in output order
  find_start_code(buf, offset, four_byte=False)

Return codes follow the reference contract: 0 success, ENOTSUP
unsupported feature, EBADMSG erroneous NAL, ENOBUFS wait for a free frame
slot, ENODATA drained at end of stream.  The pixel path runs on `cuda`
unless the caller passes device="cpu".
"""

from __future__ import annotations

import errno
from dataclasses import dataclass

import numpy as np


@dataclass
class Frame:
    """A decoded frame view (reference: Edge264Frame, edge264.h:45-62)."""

    y: np.ndarray           # [height_Y, width_Y] uint8 (cropped)
    cb: np.ndarray          # [height_C, width_C]
    cr: np.ndarray
    frame_id: int = -1
    # second MVC view, if any
    y_mvc: np.ndarray | None = None
    cb_mvc: np.ndarray | None = None
    cr_mvc: np.ndarray | None = None
    frame_id_mvc: int = -1
    mb_errors: np.ndarray | None = None   # [mb_h, mb_w] uint8 percent, or None
    bit_depth_y: int = 8
    bit_depth_c: int = 8
    crop_offsets: tuple = (0, 0, 0, 0)    # top, right, bottom, left
    timing: tuple = (0, 0)   # VUI (num_units_in_tick, time_scale), 0 = absent
    return_arg: object = None


def pixel_device(device=None):
    """The pixel path's torch device: None -> "cuda", which raises when no
    CUDA device is present; "cpu" runs the plain versions."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to decode on "
                           "the CPU")
    return dev


def find_start_code(buf: bytes, offset: int = 0, four_byte: bool = False) -> int:
    """Return the index of the next 00 00 01 (or 00 00 00 01) start-code
    prefix at/after `offset`, or len(buf) if none.  Mirrors
    edge264_find_start_code (edge264.c:87)."""
    n = 4 if four_byte else 3
    pat = b"\x00" * (n - 1) + b"\x01"
    i = buf.find(pat, offset)
    return len(buf) if i < 0 else i


class Decoder:
    """Streaming H.264 decoder: host C++ entropy front end + PyTorch pixel
    backend (ops/backend.TorchBackend).  device: None -> "cuda" (raises
    without a card); "cpu" runs the plain versions."""

    def __init__(self, n_tasks: int = 0, log_cb=None, log_mbs: bool = False,
                 device=None, backend="torch"):
        from .core import DecoderCore
        self._core = DecoderCore(log_cb=log_cb, log_mbs=log_mbs,
                                 device=device, backend=backend,
                                 n_tasks=n_tasks)

    def decode_nal(self, buf) -> int:
        """Decode one NAL unit (without its start code).  None or an empty
        buffer drains the DPB (end-of-stream semantics)."""
        return self._core.decode_nal(buf)

    def get_frame(self, borrow: bool = False) -> Frame | None:
        return self._core.get_frame(borrow)

    def return_frame(self, frame: Frame) -> None:
        self._core.return_frame(frame)

    def flush(self) -> None:
        self._core.flush()

    def close(self) -> None:
        self._core.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decode_annexb(stream: bytes, **kw):
    """Decode a whole Annex-B stream; returns an iterator of Frames in
    output order (the reference's decode_file loop).  The Decoder is made
    here, so a missing card raises at the call, not at the first frame."""
    return _decode_all(Decoder(**kw), stream)


def _decode_all(dec, stream):
    with dec:
        pos = find_start_code(stream, 0) + 3
        res = 0
        stall = 0
        while res in (0, errno.ENOBUFS, errno.ENOTSUP, errno.EBADMSG):
            end = find_start_code(stream, pos)
            res = dec.decode_nal(stream[pos:end] if pos < len(stream)
                                 else None)
            stall += 1
            while (frm := dec.get_frame()) is not None:
                yield frm
                stall = 0
            if res != errno.ENOBUFS:
                pos = end + 3
            elif stall > 0:
                # incomplete frames can never complete: cap the stall
                # whatever wait_frame reports (an MVC pair whose non-base
                # view is pending must not spin forever)
                if stall > 64:
                    break
                # frame-task mode: the head frame may still be parsing on
                # a worker; block for it instead of spinning
                if dec._core.wait_frame() == 0:
                    continue
