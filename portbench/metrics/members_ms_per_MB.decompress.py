"""The decode's member walk (runtime/device_decode.parse_blocks: the
members chained from the scanned markers, each block cut at the next
marker), ms per MB of output: the port's lap 'members'. A port without the
walk has no such lap, and the reader stays silent."""


STAGES = ('members',)

EXAMPLE = ({"op": "decompress", "clocked": {"calls": 4, "wall_s": 2.0, "MB": 50.0,
                                            "laps": {"parse": 0.6, "members": 0.05, "rle1_crc": 0.3}}},
           1.0)


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "decompress" or not all(s in c["laps"] for s in STAGES):
        return None
    return 1e3 * sum(c["laps"][s] for s in STAGES) / c["MB"]
