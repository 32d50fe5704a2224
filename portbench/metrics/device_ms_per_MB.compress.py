"""Device time of the compress (kernels and torch ops on the card: the union
of the profiler's device intervals), ms per MB of input, over the
profiled calls."""


def read(rec: dict) -> float | None:
    p = rec["profiled"]
    if rec["op"] != "compress" or not p.get("busy_s"):
        return None
    return 1e3 * p["busy_s"] / p["MB"]
