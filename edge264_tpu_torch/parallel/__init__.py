"""Scaling over devices and processes: the lockstep driver (batch.py) and
the frame batch (mesh.py) split their lane / frame axis over a mesh of
devices, and distributed.py gives each process a contiguous share of a
stream's closed GOPs."""

from .mesh import decode_batch_sharded, make_decode_mesh  # noqa: F401
