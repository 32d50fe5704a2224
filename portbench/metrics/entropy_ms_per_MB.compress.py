"""MTF, RLE2 emission, Huffman and packing (ops/mtf.py, ops/huffman.py,
ops/emit.py; kernels K3 and D2), ms per MB of input: the port's laps
'mtf', 'rle2_out', 'huffman' and 'pack' over the clocked calls."""


STAGES = ('mtf', 'rle2_out', 'huffman', 'pack')


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "compress" or not all(s in c["laps"] for s in STAGES):
        return None
    return 1e3 * sum(c["laps"][s] for s in STAGES) / c["MB"]
