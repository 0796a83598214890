"""set_env_ms: the tick's set_env phase (the projection and vs
re-derivation, the warm start, RobotData: `mpc.py` steps 1-4), device-clock
ms per tick, from the program's `PhaseTimer` span ``set_env`` (CUDA
events on the stream, so launches the host has not made yet count)."""


def read(ctx):
    return ctx["spans_ms"].get("set_env")
