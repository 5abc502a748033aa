"""The split-key plan and the ticket counters shared by the decode kernels
(``csrc/flash_decode.cuh``, ``csrc/split_merge.cuh``): the dense
flash-decode (``decode_attention``) and the paged one (``paged_attention``).

A call's W * G query rows per kv head are cut into tiles of ``ROWS``; each
tile's visible keys are shared out over ``n_splits`` CTAs, whose partials
the last CTA of the group merges. The counters are one zeroed buffer per
device, shared by both kernels, allocated at the first split call and left
zeroed by every call; calls on one device are assumed to run in stream
order, as the samplers and the engine make them.
"""
from __future__ import annotations

import torch

ROWS = 16               # query rows per CTA (flash_decode.cuh: kRows)
HEAD_DIMS = (64, 128, 256)   # the widths both decode kernels are compiled for
SPLIT_TARGET = 132      # CTAs a call aims for: one per SM of the H100
MIN_SPLIT_KEYS = 64     # the fewest keys per split of a tile's widest span
MAX_SPLITS = 64         # the kernel's merge holds this many partials a row
COUNTERS = 1 << 16      # ticket counters per device: groups a call may have
COUNTER_BUFS: dict = {}


def split_plan(S: int, W: int, G: int, KV: int, B: int, window: int = 0):
    """(n_tiles, n_splits) of a call over a key span of ``S`` positions:
    its ``W * G`` query rows per kv head in tiles of ``ROWS``, and the
    number of key splits each tile's visible keys are shared out over (each
    split takes an even share of them, counted on the device from the
    lengths). Chosen from what the host knows, never from the lengths:
    enough CTAs to fill the card, and no more splits than a tile's widest
    possible span (all S keys, or the window plus the tile's positions)
    fills at ``MIN_SPLIT_KEYS`` each."""
    n_tiles = -(-W * G // ROWS)
    span = S if window <= 0 else min(S, window + 15 // G + 1)
    want = -(-SPLIT_TARGET // (n_tiles * KV * B))
    return n_tiles, max(1, min(want, -(-span // MIN_SPLIT_KEYS), MAX_SPLITS))


def split_buffers(name: str, device, groups: int, n_splits: int, d: int):
    """(workspace, its pointer, the counters' pointer) of a call with
    ``groups`` row tiles x kv heads x sequences split ``n_splits`` ways at
    head width ``d``; all None for one split, which writes its output
    directly. The float32 workspace holds each split's partial (m, l, acc)
    of its rows; the caller keeps it alive until the launch is issued."""
    if n_splits == 1:
        return None, None, None
    if groups > COUNTERS:
        raise ValueError(f"{name}: {groups} row tiles x kv heads x "
                         f"sequences; the kernel counts at most {COUNTERS}")
    buf = COUNTER_BUFS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: call a split-key decode kernel once "
                               "outside CUDA graph capture first (its ticket "
                               "counters are allocated at the first split "
                               "call)")
        buf = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
        COUNTER_BUFS[device] = buf
    ws = torch.empty(groups * n_splits * ROWS * (d + 2), dtype=torch.float32,
                     device=device)
    return ws, ws.data_ptr(), buf.data_ptr()
