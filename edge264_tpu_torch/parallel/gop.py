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
    no mid-stream IDR yields one chunk)."""
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
    for nal in nals:
        t = nal[3] & 31
        if t in (7, 8, 15):                 # SPS / PPS / subset SPS
            # NOT flushed into the open GOP: sets arriving between GOPs
            # belong to the NEXT one (a later same-id PPS would
            # otherwise override the open GOP's in its prefix)
            ps += nal
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
                cur = b""
            in_idr = True
        else:
            in_idr = False
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
    through its own `decode_annexb` (keywords such as `device` pass
    through); returns an iterator of Frames in stream order.  Like
    decode_annexb, it raises at the call when the device is missing."""
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
