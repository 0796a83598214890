"""host_syncs_per_tick: the device-to-host syncs one tick asks for from the
program's own frames (`mpc.py`, `solver/sqp.py` and below), counted by
`torch.cuda.set_sync_debug_mode("warn")` over the ticks run after the
traced window; the harness's end-of-tick synchronize is not among them."""


def read(ctx):
    if not ctx["sync_ticks"]:
        return None
    return ctx["syncs"] / ctx["sync_ticks"]
