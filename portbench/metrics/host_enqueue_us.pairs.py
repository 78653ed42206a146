"""Mean host microseconds from the call into ``match_batch`` to its return,
no synchronisation, over the window's batches outside the traced slice."""


def read(ctx):
    enq = ctx.window.get("enqueue_s")
    return 1e6 * sum(enq) / len(enq) if enq else None
