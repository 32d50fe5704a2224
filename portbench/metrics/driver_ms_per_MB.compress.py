"""The compress driver's host time (runtime/compressor.py: split, copies to
and from the card, stitch), ms per MB of input: a clocked call's wall
less the port's stage laps, which cover ops/pipeline.encode_batch."""


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "compress" or not c["laps"]:
        return None
    return 1e3 * (c["wall_s"] - sum(c["laps"].values())) / c["MB"]
