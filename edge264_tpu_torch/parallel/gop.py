"""GOP-level parallel decoding: closed GOPs (IDR..IDR) are independent,
so a stream is split at IDR boundaries, for the lockstep driver or for
whole decoders running concurrently on worker threads (port of
`parallel/gop.py`: `split_gops`, `_read_ue`, `decode_annexb_parallel`).
The C++ front end releases the interpreter lock inside decode_nal, so one
GOP's host parsing overlaps another's device work."""

from __future__ import annotations

import threading

from ..api import decode_annexb, find_start_code, pixel_device


def split_gops(stream: bytes):
    """Split an Annex-B stream into per-GOP chunks, each prefixed with
    every parameter set seen so far.  Returns [bytes, ...] (a stream with
    no mid-stream IDR yields one chunk).

    A parameter set (SPS, PPS, subset SPS) that arrives while a GOP is
    open, with more of that GOP's slices after it, also goes into that
    GOP before those slices, so they find it as the serial decoder does.
    This is a deliberate difference from the JAX package's split_gops,
    which only prefixes it to the next GOP (its parallel paths then lose
    a PPS that arrives mid-GOP)."""
    nals = []
    pos = find_start_code(stream, 0)
    while pos < len(stream):
        end = find_start_code(stream, pos + 3)
        nals.append(stream[pos:end])
        pos = end
    ps = b""
    gops = []
    cur = b""
    cur_ps = b""         # parameter-set snapshot when the open GOP began
    pending = b""        # MVC prefix NAL(s) awaiting their slice
    in_idr = False       # currently appending slices of an IDR frame
    mid_ps = b""         # parameter sets inside the open GOP, held until
    #                      its next slice
    for nal in nals:
        t = nal[3] & 31
        if t in (7, 8, 15):                 # SPS / PPS / subset SPS
            # into the prefix of the next GOPs, and, once another slice of
            # the open GOP follows, into that GOP before the slice.  Never
            # into the open GOP's prefix, where a later same-id PPS would
            # override the one its earlier slices use; and not into a GOP
            # that no slice follows in (a format-changing SPS there would
            # drain and flush that GOP's decoder)
            ps += nal
            if cur:
                mid_ps += nal
            continue
        if t == 14:
            # MVC prefix NAL precedes its slice; if that slice opens a
            # new GOP the prefix must move with it
            pending += nal
            continue
        if t == 5:
            # Only the FIRST slice of an IDR frame opens a new GOP: later
            # slices have first_mb_in_slice != 0 (ue(v) right after the
            # NAL header, §7.3.3) and must stay with their frame.
            first_mb = _read_ue(nal, 4)
            if cur and not (in_idr and first_mb != 0):
                gops.append(cur_ps + cur)
                cur = mid_ps = b""
            in_idr = True
        else:
            in_idr = False
        if mid_ps and (1 <= t <= 5 or t == 20):    # a slice of the open GOP
            cur += mid_ps
            mid_ps = b""
        if not cur:
            cur_ps = ps
        cur += pending + nal
        pending = b""
    if cur or pending:
        gops.append((cur_ps if cur else ps) + cur + pending)
    return gops


def _read_ue(nal: bytes, byte_off: int) -> int:
    """First Exp-Golomb value starting at byte_off (enough bits for
    first_mb_in_slice; emulation-prevention can't occur this early in a
    slice header with first_mb reasonable)."""
    bits = 0
    n = 0
    for b in nal[byte_off:byte_off + 8]:
        bits = bits << 8 | b
        n += 8
    lead = 0
    while lead < n and not (bits >> (n - 1 - lead)) & 1:
        lead += 1
    if 2 * lead + 1 > n:
        return 0
    return (bits >> (n - 2 * lead - 1) & ((1 << (lead + 1)) - 1)) - 1


def decode_annexb_parallel(stream: bytes, n_workers: int = 4, **kw):
    """Decode a whole stream with up to `n_workers` GOPs in flight, each
    through its own `decode_annexb` (keywords such as `device` and
    `backend` pass through); returns an iterator of Frames in stream
    order.  Like decode_annexb, it raises at the call when the device is
    missing; backend="numpy" runs on the host and ignores `device`."""
    if kw.get("backend", "torch") == "torch":
        kw["device"] = pixel_device(kw.get("device"))
    if n_workers < 1:
        raise ValueError(f"n_workers={n_workers}")
    gops = split_gops(stream)
    if len(gops) <= 1:
        return decode_annexb(stream, **kw)
    return _decode_parallel(gops, n_workers, kw)


def _decode_parallel(gops, n_workers, kw):
    results = [None] * len(gops)
    errors = [None] * len(gops)
    sem = threading.Semaphore(n_workers)

    def work(i):
        with sem:
            try:
                results[i] = list(decode_annexb(gops[i], **kw))
            except Exception as e:   # re-raised on the consuming thread
                errors[i] = e

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(gops))]
    for t in threads:
        t.start()
    try:
        for i, t in enumerate(threads):
            t.join()
            if errors[i] is not None:
                raise errors[i]
            yield from results[i]
            results[i] = None
    finally:
        for t in threads:
            t.join()
