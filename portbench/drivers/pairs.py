"""Closed-loop batched pair matching through ``match_batch``.

Traffic parameters (``portbench/traffic/<mix>.json``): ``precision``
(``exact`` or ``fast``), ``in_flight`` (batches submitted and not yet read
back), ``pool`` (distinct batches made at set-up and sent in turn),
``warmup_seconds`` (the loop run before the window, so that clocks and
caches are steady), ``trace_seconds`` (the slice of the window that a
traced run profiles) and ``check_batches`` (the window's answers that the
check draws from the seed).

Configuration (``portbench/configs/<config>.json``): ``batch`` pairs of
``capacity`` slots, ``live`` live ``dim``-wide descriptors a side, unit
|N(0, 1)| queries, and a bank that is a permuted copy of its queries with
N(0, ``noise``) added (``noise`` scaled by sqrt(128 / dim)), made unit
again; ``ratio`` and ``cross_check`` as the matcher takes them.

A batch's latency runs from its submission to its matches (idx, valid,
dist) on the host; ``latency_off_s`` keeps those of the batches that
completed while the profiler was off. Its matches are copied to pinned host buffers on a
stream of their own, so the copy of one batch overlaps the next batch's
kernels.
"""

from __future__ import annotations

import math
import random
import time

import torch

from portbench.reference import matcher as reference

SPANS = ("match_batch", "readback")


def make_pool(cfg, n_batches, seed, device):
    """``n_batches`` batches of (queries, bank, mask_a, mask_b), made on
    ``device`` from ``seed``: float32 (B, capacity, dim) and bool (B,
    capacity) masks with the first ``live`` slots live."""
    B, cap, live, dim = cfg["batch"], cfg["capacity"], cfg["live"], cfg["dim"]
    if live > cap:
        raise ValueError("live rows exceed the capacity")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    noise = cfg["noise"] * math.sqrt(128 / dim)
    mask = torch.zeros((B, cap), dtype=torch.bool, device=device)
    mask[:, :live] = True
    pool = []
    for _ in range(n_batches):
        a = torch.randn((B, live, dim), generator=gen, device=device).abs_()
        a /= torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        b = (a + noise * torch.randn(a.shape, generator=gen, device=device)).abs_()
        b /= torch.linalg.vector_norm(b, dim=-1, keepdim=True)
        perm = torch.rand((B, live), generator=gen, device=device).argsort(dim=-1)
        b = torch.gather(b, 1, perm[..., None].expand(-1, -1, dim))
        qa = torch.zeros((B, cap, dim), device=device)
        qb = torch.zeros((B, cap, dim), device=device)
        qa[:, :live], qb[:, :live] = a, b
        pool.append((qa, qb, mask, mask))
    return pool


class Driver:
    """One cell of batched matching: set-up, window, check."""

    def __init__(self, cfg, traffic, seed, device, fm):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fm = fm                      # the port's package
        self.fast = traffic["precision"] == "fast"
        self.in_flight = int(traffic["in_flight"])
        self.pool = make_pool(cfg, int(traffic["pool"]), seed, device)
        self.descs = [(fm.Descriptors(a, ma), fm.Descriptors(b, mb))
                      for a, b, ma, mb in self.pool]
        B, cap = cfg["batch"], cfg["capacity"]
        cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if cuda else None
        self.slots = [dict(idx=torch.empty((B, cap), dtype=torch.int32, pin_memory=cuda),
                           valid=torch.empty((B, cap), dtype=torch.bool, pin_memory=cuda),
                           dist=torch.empty((B, cap), dtype=torch.float32, pin_memory=cuda),
                           event=torch.cuda.Event() if cuda else None,
                           job=None)
                      for _ in range(self.in_flight)]
        self.live = [int(cfg["live"])] * B
        self.draw = random.Random(seed)
        self.offset = self.draw.randrange(len(self.pool))
        self._reset_sample(int(traffic["check_batches"]))
        self.t_last = None

    def _reset_sample(self, size):
        """An empty sample of ``size`` answers, drawn from the seed by
        reservoir during the window into buffers on the device made here: a
        sampled answer is copied there by the device, so that drawing it
        costs the loop three launches and no host copy."""
        B, cap, dev = self.cfg["batch"], self.cfg["capacity"], self.device
        self.sample, self.seen, self.sample_size = [], 0, size
        self.sample_bufs = [(torch.zeros((B, cap), dtype=torch.int32, device=dev),
                             torch.zeros((B, cap), dtype=torch.bool, device=dev),
                             torch.zeros((B, cap), dtype=torch.float32, device=dev))
                            for _ in range(size)]

    # -- the loop ----------------------------------------------------------

    def _submit(self, k, slot, tracer, keep):
        j = (k + self.offset) % len(self.pool)
        da, db = self.descs[j]
        t_sub = time.perf_counter()
        with tracer.span("match_batch"):
            m = self.fm.match_batch(da, db, ratio=self.cfg["ratio"],
                                    cross_check=self.cfg["cross_check"], backend="kernel",
                                    precision="fast" if self.fast else "exact",
                                    device=self.device)
        t_ret = time.perf_counter()
        if tracer.on:
            tracer.record("match_batch", (self.live, self.live, self.cfg["capacity"],
                                          self.cfg["capacity"], self.cfg["dim"], self.fast))
        if self.copy_stream is not None:
            self.copy_stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.copy_stream):
                slot["idx"].copy_(m.idx, non_blocking=True)
                slot["valid"].copy_(m.valid, non_blocking=True)
                slot["dist"].copy_(m.dist, non_blocking=True)
                slot["event"].record(self.copy_stream)
        else:
            slot["idx"].copy_(m.idx)
            slot["valid"].copy_(m.valid)
            slot["dist"].copy_(m.dist)
        # The outputs stay referenced until their copy is read, so the
        # allocator cannot hand their memory to a later batch first.
        slot["job"] = (j, t_sub, m, keep)
        return t_ret - t_sub

    def _complete(self, slot, tracer, stats):
        with tracer.span("readback"):
            if slot["event"] is not None:
                slot["event"].synchronize()
        t_done = self.t_last = time.perf_counter()
        j, t_sub, m, keep = slot["job"]
        slot["job"] = None
        if stats is not None:
            stats["latency_s"].append(t_done - t_sub)
            if not tracer.on:
                stats["latency_off_s"].append(t_done - t_sub)
        if keep:
            self._offer(j, m)

    def _offer(self, j, m):
        """Reservoir sampling of the window's answers ``m``, driven by the
        seed: ``sample`` holds (pool index, idx, valid, dist) on the device,
        each copied after the kernels that made it."""
        self.seen += 1
        if len(self.sample) < self.sample_size:
            pos = len(self.sample)
            self.sample.append(None)
        else:
            pos = self.draw.randrange(self.seen)
            if pos >= self.sample_size:
                return
        idx, valid, dist = self.sample_bufs[pos]
        idx.copy_(m.idx, non_blocking=True)
        valid.copy_(m.valid, non_blocking=True)
        dist.copy_(m.dist, non_blocking=True)
        self.sample[pos] = (j, idx, valid, dist)

    def _loop(self, seconds, tracer, stats, keep, trace_slice=None):
        """Submit batches for ``seconds`` with ``in_flight`` outstanding,
        then read back the rest; with ``trace_slice`` (offset, length),
        profile that slice, drained at both ends. Returns (batches, first
        submission time, last completion time)."""
        k = 0
        state = "before" if trace_slice else "done"
        t0 = time.perf_counter()
        self.t_last = t0
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if state == "before" and now - t0 >= trace_slice[0]:
                self._drain(k, tracer, stats, keep)
                tracer.start()
                t_trace, state = time.perf_counter(), "on"
            elif state == "on" and now - t_trace >= trace_slice[1]:
                self._drain(k, tracer, stats, keep)
                tracer.stop()
                state = "done"
            slot = self.slots[k % self.in_flight]
            if slot["job"] is not None:
                self._complete(slot, tracer, stats)
            enq = self._submit(k, slot, tracer, keep)
            if stats is not None and state != "on":
                stats["enqueue_s"].append(enq)
            k += 1
        self._drain(k, tracer, stats, keep)
        if state == "on":
            tracer.stop()
        return k, t0, self.t_last

    def _drain(self, k, tracer, stats, keep):
        """Read back every batch still in flight, oldest first."""
        for i in range(max(0, k - self.in_flight), k):
            slot = self.slots[i % self.in_flight]
            if slot["job"] is not None:
                self._complete(slot, tracer, stats)

    def warm_up(self, tracer):
        """Every pool batch once (the first call builds K1), then the loop
        for ``warmup_seconds``."""
        for k in range(len(self.pool)):
            slot = self.slots[0]
            self._submit(k, slot, tracer, False)
            self._complete(slot, tracer, None)
        self._loop(float(self.traffic["warmup_seconds"]), tracer, None, False)

    def window(self, seconds, tracer):
        stats = dict(latency_s=[], latency_off_s=[], enqueue_s=[])
        trace_slice = None
        if tracer.enabled:
            span = min(float(self.traffic["trace_seconds"]), seconds)
            trace_slice = ((seconds - span) / 2, span)
        batches, t0, t1 = self._loop(seconds, tracer, stats, True, trace_slice)
        B = self.cfg["batch"]
        return dict(seconds=t1 - t0, batches=batches, pairs=batches * B,
                    attempted=batches, failed=batches - len(stats["latency_s"]), **stats)

    # -- the check ---------------------------------------------------------

    def free(self):
        for slot in self.slots:
            slot["job"] = None

    def readings(self, sample, operands=None):
        """(most decisions off in one batch, largest distance gap) of
        ``sample`` [(pool index, idx, valid, dist)] against the float64
        reference of each batch's inputs."""
        refs, off, gap = {}, 0, 0.0
        for j, idx, valid, dist in sample:
            if j not in refs:
                a, b, ma, mb = self.pool[j]
                refs[j] = reference.match_reference(
                    a, b, ma, mb, ratio=self.cfg["ratio"],
                    cross_check=self.cfg["cross_check"], fast=self.fast)
            o, g = reference.compare(idx, valid, dist, refs[j], self.pool[j][2])
            off, gap = max(off, o), max(gap, g)
        return off, gap

    def control_sample(self, operands):
        """The reference put in the port's place, with its operands rounded
        to ``operands`` and its sums in float32: one answer a pool batch."""
        out = []
        for j, (a, b, ma, mb) in enumerate(self.pool):
            idx, valid, d1, _, _ = reference.match_reference(
                a, b, ma, mb, ratio=self.cfg["ratio"], cross_check=self.cfg["cross_check"],
                fast=self.fast, operands=operands, dtype=torch.float32)
            out.append((j, idx.cpu(), valid.cpu(), torch.where(valid, d1, reference.BIG).cpu()))
        return out

    def program_sample(self, tracer):
        """The port's answer to every pool batch, through the window's calls."""
        self._reset_sample(len(self.pool))
        for k in range(len(self.pool)):
            slot = self.slots[0]
            self._submit(k, slot, tracer, True)
            self._complete(slot, tracer, None)
        return self.sample

    def check(self, limits):
        """The window's sampled answers against the reference's, computed
        in float64 from the pool's inputs."""
        off, gap = self.readings(self.sample)
        return [dict(name="decisions_off", value=off, limit=limits["decisions_off"]),
                dict(name="dist_gap", value=gap, limit=limits["dist_gap"]),
                dict(name="batches_checked", value=len(self.sample), limit=1, least=True)]
