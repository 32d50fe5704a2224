"""The share of the profiled compress window in which no operation ran on
the card, in percent: 100 (1 - busy / window)."""


def read(rec: dict) -> float | None:
    p = rec["profiled"]
    if rec["op"] != "compress" or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
