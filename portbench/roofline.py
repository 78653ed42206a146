"""Peaks of one NVIDIA H100 and the work of each timed entry, from shapes.

The yardstick of every roofline share the benchmark prints. A share is the
least time the card could take for the work (the larger of operations over
the peak rate of the operands' type and bytes over the memory rate) over
the device time the work took. The work is counted from the shapes of the
calls into the port, so it reads the same whatever implements the call.

Counting rules, copied from the port's chip smoke (``chip_smoke.py``:
``bound``, ``k1_bound`` and the K4 and K5 checks):

- K1 (batched matching): one product per live query and live bank row,
  ``2 * dim`` operations each; the live rows' operands (4 bytes an element
  exact, 2 in bf16), both masks (1 byte an entry) and the three outputs
  (idx, dist, valid: 9 bytes a query slot) once each.
- K4 (sorted segment sum): the rows read once, the ``n + 1`` segment
  offsets read once, the ``n`` sums written once, 4 bytes an element.
- K5 (sorted row gather): the keys read once, the distinct table rows
  read once, the gathered rows written once, 4 bytes an element.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12      # outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def bound_s(n_bytes: float, n_ops: float = 0.0, peak_ops: float = PEAK_FP32_FLOPS):
    """(seconds, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_ops / peak_ops
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def match_work(live_a, live_b, capacity_a: int, capacity_b: int, dim: int, fast: bool):
    """(operations, bytes, peak) of one batched match call: ``live_a`` and
    ``live_b`` the live rows of each pair's queries and bank (sequences of
    equal length, one entry a pair)."""
    if len(live_a) != len(live_b):
        raise ValueError("one live count a pair on each side")
    ops = 2.0 * dim * sum(float(a) * float(b) for a, b in zip(live_a, live_b))
    row_bytes = (2 if fast else 4) * dim
    pairs = len(live_a)
    n_bytes = (row_bytes * float(sum(live_a) + sum(live_b))
               + pairs * (capacity_a + capacity_b) + 9 * pairs * capacity_a)
    return ops, n_bytes, PEAK_BF16_FLOPS if fast else PEAK_FP32_FLOPS


def segsum_bytes(rows: int, cols: int, segments: int) -> float:
    """Bytes of one sorted segment sum of ``rows`` x ``cols`` float32 rows
    into ``segments`` sums."""
    return 4.0 * (rows * cols + segments + 1 + segments * cols)


def gather_bytes(keys: int, cols: int, distinct: int) -> float:
    """Bytes of one sorted gather of ``keys`` rows of ``cols`` float32
    columns from a table of which ``distinct`` rows are read."""
    return 4.0 * (keys + keys * cols + distinct * cols)
