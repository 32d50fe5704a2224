"""The Huffman decode (ops/huffman_dec.py, kernels D1 and D3), ms per MB
of output: the port's lap 'huffman'."""


STAGES = ('huffman',)


def read(rec: dict) -> float | None:
    c = rec["clocked"]
    if rec["op"] != "decompress" or not all(s in c["laps"] for s in STAGES):
        return None
    return 1e3 * sum(c["laps"][s] for s in STAGES) / c["MB"]
