"""Matching <-> BA overlap scheduler.

Port of ``fastmatch_tpu/dist/overlap.py``. A double-buffered two-stage
pipeline for the SLAM loop: while block k's second stage (BA) runs, block
k+1's first stage (matching) is already in flight. The JAX package gets
the overlap from asynchronous dispatch; on the card it comes from two CUDA
streams: every ``stage_a`` is issued on a side stream, ``stage_b`` on the
caller's stream, and an event recorded after ``stage_a(k)`` orders
``stage_b(k)`` after it. Tensors cross streams marked with
``record_stream``, so the allocator does not reuse their memory while the
other stream may still read it. On the CPU the calls run in order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch


def tensors_of(tree) -> list:
    """The tensors of a tree of tuples, lists, dicts and NamedTuples."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors_of(x)]
    return []


class OverlapScheduler:
    """Double-buffered two-stage pipeline: stage_a feeds stage_b per block.

    stage_a: block -> intermediate (e.g. sharded matching of block k)
    stage_b: intermediate -> result (e.g. BA on block k's matches)

    Issue order per step k: stage_a(k+1) BEFORE waiting on stage_b(k), so
    the card stays busy. Results are returned in block order, equal to the
    serial schedule's (no state is shared between blocks mid-flight).
    ``device``: the blocks' device (``cuda``: two streams; ``cpu``: in
    order)."""

    def __init__(self, stage_a: Callable[[Any], Any], stage_b: Callable[[Any], Any],
                 device=None):
        self.stage_a = stage_a
        self.stage_b = stage_b
        self.device = torch.device("cuda" if device is None else device)

    def run(self, blocks: Iterable[Any]):
        blocks = list(blocks)
        if not blocks:
            return []
        if self.device.type != "cuda":
            return [self.stage_b(self.stage_a(b)) for b in blocks]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        # The blocks were written on the caller's stream: the side stream
        # starts after them, and their memory stays theirs while it reads.
        side.wait_stream(main)
        for t in tensors_of(blocks):
            t.record_stream(side)

        def issue_a(block):
            with torch.cuda.stream(side):
                inter = self.stage_a(block)
                done = torch.cuda.Event()
                done.record(side)
            return inter, done

        results = []
        inter, done = issue_a(blocks[0])
        for k in range(len(blocks)):
            main.wait_event(done)
            for t in tensors_of(inter):
                t.record_stream(main)
            pending_b = self.stage_b(inter)  # consumes a(k)
            if k + 1 < len(blocks):
                inter, done = issue_a(blocks[k + 1])  # overlaps with b(k)
            results.append(pending_b)
        # Materialize at the end (single sync point).
        main.synchronize()
        return results
