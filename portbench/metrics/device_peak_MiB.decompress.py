"""Peak device memory the caching allocator handed out over the traced
decode window (torch.cuda.max_memory_allocated), MiB."""


def read(rec: dict) -> float | None:
    if rec["op"] != "decompress" or not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2**20
