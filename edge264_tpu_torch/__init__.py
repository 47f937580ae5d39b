"""edge264_tpu_torch: the H.264/AVC decoder's pixel path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The C++ entropy front end (`native/`) parses on the host; the lockstep
driver (`parallel.batch.decode_gops_batched`) decodes K closed GOPs at a
time on the device.  Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""

from .api import Decoder, Frame, decode_annexb, find_start_code

__all__ = ["Decoder", "Frame", "decode_annexb", "find_start_code"]
