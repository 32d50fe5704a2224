"""The BWT (ops/bwt.py, kernels K1 and K2), ms per MB of input: the port's
lap 'bwt' over the clocked calls."""


STAGES = ('bwt',)


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "compress" or not all(s in c["laps"] for s in STAGES):
        return None
    return 1e3 * sum(c["laps"][s] for s in STAGES) / c["MB"]
