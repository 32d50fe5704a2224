"""Inverse MTF and inverse BWT (ops/mtf_dec.py with kernel D4, ops/ibwt.py),
ms per MB of output: the port's laps 'mtf' and 'ibwt'."""


STAGES = ('mtf', 'ibwt')


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "decompress" or not all(s in c["laps"] for s in STAGES):
        return None
    return 1e3 * sum(c["laps"][s] for s in STAGES) / c["MB"]
