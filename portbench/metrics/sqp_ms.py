"""sqp_ms: the SQP loop's phases (`solver/sqp.py`: set_qp, solve_qp,
get_alpha), device-clock ms per tick, from the program's `PhaseTimer`
spans."""

PHASES = ("set_qp", "solve_qp", "get_alpha")


def read(ctx):
    found = [ctx["spans_ms"][p] for p in PHASES if p in ctx["spans_ms"]]
    return sum(found) if found else None
