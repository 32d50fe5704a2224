"""Device time of the decode (the union of the profiler's device
intervals), ms per MB of output, over the profiled calls."""


def read(rec: dict) -> float | None:
    p = rec["profiled"]
    if rec["op"] != "decompress" or not p.get("busy_s"):
        return None
    return 1e3 * p["busy_s"] / p["MB"]
