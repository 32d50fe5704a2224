"""The decode driver (runtime/device_decode.py): block scan and header
parse, table packing and upload, inverse RLE1 and CRCs, ms per MB of
output: the port's laps 'parse', 'tables' and 'rle1_crc'."""


STAGES = ('parse', 'tables', 'rle1_crc')


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "decompress" or not all(s in c["laps"] for s in STAGES):
        return None
    return 1e3 * sum(c["laps"][s] for s in STAGES) / c["MB"]
