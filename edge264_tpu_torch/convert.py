"""The per-step state carried from numpy (the native front end, or a test's
arrays) into port tensors on a device.

The port has no learned weights: its "parameters" are the constant
tables (ops/tables.py) and this per-step state -- the syntax planes of K
frames and the reference rings.
"""

from __future__ import annotations

import numpy as np
import torch

# syntax planes a step reads (jaxdec.PLANE_KEYS)
PLANE_KEYS = ["mb_flags", "qp", "i4_modes", "i16_modes", "i8_modes",
              "ch_modes", "coef_y", "coef_y8", "coef_y_dc", "coef_c_dc",
              "coef_cb", "coef_cr", "pcm_y", "pcm_c", "nz_y", "refslot",
              "mvs", "deblock", "deblock_ab", "wp", "wp8", "mb_errors",
              "slice_id"]
# every plane starts at a multiple of this many int32s (16 bytes): the
# kernels fetch planes with 16-byte cp.async copies, which need the
# address aligned to the copy size
ALIGN = 4
# planes that go to the device only once some frame of the stream needs
# them (the lockstep driver's sticky `keep` set); otherwise zeros, exactly
# as the JAX arena ships them
CONDITIONAL = frozenset({"coef_y8", "i8_modes", "pcm_y", "pcm_c",
                         "mb_errors", "slice_id", "wp", "wp8"})


def _get(pl, k):
    return np.asarray(pl[k] if isinstance(pl, dict) else getattr(pl, k))


def planes_to_torch(planes_list, keep, device, extra=None):
    """Stack K frames' syntax planes into int32 tensors [K, ...] on
    `device` with ONE host-to-device copy.  No decode path uses it: they
    upload the packed arena (ops/arena.py).  It builds kernel inputs from
    synthetic planes (chip_smoke.py, the tests).

    planes_list: per lane a native SyntaxPlanes, a dict of numpy arrays
    (holding a subset of PLANE_KEYS), or None (a dead lane: all zeros).
    Planes in CONDITIONAL that are not in `keep` are zeros for every
    lane.  `extra` maps further names to
    int32-convertible arrays [K, ...] that ride the same copy (the step's
    scaling matrices, slot maps and ring slots).  Returns {name: tensor}.
    """
    ref = next(pl for pl in planes_list if pl is not None)
    K = len(planes_list)
    keys = [k for k in PLANE_KEYS if not isinstance(ref, dict) or k in ref]
    shapes = {k: _get(ref, k).shape for k in keys}
    if "coef_c_dc" in shapes:
        shapes["coef_c_dc"] = shapes["coef_c_dc"][:2] + (2, 4)
    extra = {k: np.asarray(v) for k, v in (extra or {}).items()}
    shapes.update({k: v.shape[1:] for k, v in extra.items()})
    offs, total = {}, 0
    for k, shp in shapes.items():
        offs[k] = total
        total += -(-K * int(np.prod(shp)) // ALIGN) * ALIGN
    buf = np.zeros(total, np.int32)

    def block(k):
        n = K * int(np.prod(shapes[k]))
        return buf[offs[k]:offs[k] + n].reshape((K,) + tuple(shapes[k]))

    for k in keys:
        if k in CONDITIONAL and k not in keep:
            continue
        blk = block(k)
        for i, pl in enumerate(planes_list):
            if pl is not None:
                blk[i] = _get(pl, k).reshape(shapes[k])
    for k, v in extra.items():
        block(k)[:] = v
    dev = torch.from_numpy(buf).to(device)
    return {k: dev[offs[k]:offs[k] + K * int(np.prod(shp))]
            .view((K,) + tuple(shp)) for k, shp in shapes.items()}


def rings_from_numpy(refL, refC, device):
    """Reference rings (uint8 numpy or array-likes) -> device tensors (a
    copy: the rings are updated in place)."""
    return (torch.from_numpy(np.array(refL, np.uint8)).to(device),
            torch.from_numpy(np.array(refC, np.uint8)).to(device))
