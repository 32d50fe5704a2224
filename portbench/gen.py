"""The one generator of every traffic mix: objects of exact sizes, made
from ``--seed`` with vectorised NumPy.

A mix is a data file, ``portbench/traffic/<name>.json``:

    {"op": "compress" | "decompress",
     "objects": [{"name": ..., "bytes": ..., "class": <class name>}, ...],
     "classes": {<class name>: <class spec>, ...}}

A class spec has a ``kind``:

- ``records``: records drawn from weighted ``templates``. A template is a
  string of literal text (UTF-8) and slots: ``{pool}`` is one draw from a
  pool, ``{pool:a-b}`` is a to b draws (uniform count), each after the
  pool's ``sep``. Pools (``pools``, made once a class and the same for
  every seed): ``words`` (a vocabulary of ``size`` words of ``letters``,
  lengths about ``len``, drawn Zipf(``zipf``); ``case`` lower, title or
  upper; ``vocab`` names a vocabulary shared by pools);
  ``ints`` (``lo``..``hi`` as ``fmt``, uniform or Zipf); ``floats``
  (``distinct`` values in ``lo``..``hi`` as ``fmt``); ``choice``
  (``items``, ``hex:``-prefixed items are bytes, weights ``p`` or
  ``zipf``); ``random`` (``bytes`` fresh random bytes a draw); ``le``
  (little-endian ``bytes``-byte integers in ``lo``..``hi``);
  ``template`` (a nested template expanded afresh for every draw, padded
  with NULs to ``pad`` where given, or ``distinct`` expansions made once
  and drawn like words); ``mix`` (a weighted union of pools).
  ``tar`` wraps the records as files of about ``tar`` bytes, each behind
  a 512-byte header and padded to 512, as a tar archive is.
- ``image``: 2-D slices of ``width`` x ``height`` samples of ``bits``
  bits (16-bit containers), a smooth field over ``cells`` coarse cells
  plus Gaussian ``noise``, a ``background`` share of each slice zero.
- ``uniform``: seeded uniform bytes.

The seed chooses the draws; a class's parameters and pools are fixed, so
that seeds differ little in what the bytes cost to compress.
"""

from __future__ import annotations

import copy
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
_SLOT = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)(?::(\d+)-(\d+))?\}")
PIECE = 1 << 23  # an object is made in pieces of this many bytes
POOLS = 0x5EED  # the stream every seed's pools come from


def load_mix(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    path = Path(directory) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def make_objects(mix: dict, seed: int, threads: int = 8) -> list[tuple[str, bytes]]:
    """(name, bytes) of every object of ``mix``, from ``seed``. Object i's
    pools (its vocabularies, phrases, number formats) come from the fixed
    stream (POOLS, i), so that they are part of its class and the same for
    every seed; its piece j of ``PIECE`` bytes draws from (seed, i, j), so
    that no piece depends on the others or on the threads that make it."""
    seed &= (1 << 64) - 1
    objs = mix["objects"]

    def base(i: int):
        spec = mix["classes"][objs[i]["class"]]
        return _Records(spec, np.random.default_rng([POOLS, i])) if spec["kind"] == "records" else None

    def piece(job) -> bytes:
        i, j, n = job
        spec = mix["classes"][objs[i]["class"]]
        rng = np.random.default_rng([seed, i, j])
        if bases[i] is not None:
            return bases[i].piece(n, rng)
        return make_class(spec, n, rng)

    jobs = [(i, j, min(PIECE, int(o["bytes"]) - j * PIECE))
            for i, o in enumerate(objs) for j in range(-(-int(o["bytes"]) // PIECE))]
    with ThreadPoolExecutor(threads) as ex:
        bases = list(ex.map(base, range(len(objs))))
        made = list(ex.map(piece, jobs))
    out = []
    for i, o in enumerate(objs):
        data = b"".join(m for (k, _, n), m in zip(jobs, made) if k == i for m in [m[:n]])
        if len(data) != int(o["bytes"]):
            raise AssertionError(f"{o['name']}: made {len(data)} bytes, not {o['bytes']}")
        out.append((o["name"], data))
    return out


def make_class(spec: dict, nbytes: int, rng: np.random.Generator) -> bytes:
    """``nbytes`` of a class that has no pools (``uniform``, ``image``)."""
    kind = spec["kind"]
    if kind == "uniform":
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    if kind == "image":
        return _image(spec, nbytes, rng)
    raise ValueError(f"unknown class kind {kind!r}")


# --------------------------------------------------------------------------
# images


def _image(spec: dict, nbytes: int, rng: np.random.Generator) -> bytes:
    w, h = int(spec["width"]), int(spec["height"])
    top = (1 << int(spec["bits"])) - 1
    cells = int(spec["cells"])
    n_slices = -(-nbytes // (2 * w * h))
    coarse = rng.random((n_slices, cells + 1, cells + 1))
    # Bilinear upsampling of the coarse grid: a smooth field.
    ys = np.linspace(0, cells, h)
    xs = np.linspace(0, cells, w)
    y0 = np.minimum(ys.astype(np.int64), cells - 1)
    x0 = np.minimum(xs.astype(np.int64), cells - 1)
    fy, fx = (ys - y0)[None, :, None], (xs - x0)[None, None, :]
    a = coarse[:, y0][:, :, x0]
    b = coarse[:, y0][:, :, x0 + 1]
    c = coarse[:, y0 + 1][:, :, x0]
    d = coarse[:, y0 + 1][:, :, x0 + 1]
    field = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    field = field * top * float(spec.get("contrast", 0.8))
    field += rng.normal(0.0, float(spec["noise"]), field.shape)
    # The background: a disc's outside stays zero, as around a scanned body.
    r2 = (np.arange(h)[:, None] / h - 0.5) ** 2 + (np.arange(w)[None, :] / w - 0.5) ** 2
    outside = r2 > (0.5 - float(spec["background"]) / 2) ** 2
    field[:, outside] = 0
    px = np.clip(np.rint(field), 0, top).astype("<u2" if spec.get("endian", "little") == "little" else ">u2")
    return px.tobytes()[:nbytes]


# --------------------------------------------------------------------------
# records


def _alias(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker's alias table of the distribution p (Vose's construction): a
    draw is a uniform slot i, kept where a uniform number is below keep[i]
    and else other[i]."""
    n = p.size
    scaled = (p * n).tolist()
    keep = np.ones(n)
    other = np.arange(n)
    small = [i for i, v in enumerate(scaled) if v < 1.0]
    large = [i for i, v in enumerate(scaled) if v >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        keep[s], other[s] = scaled[s], g
        scaled[g] -= 1.0 - scaled[s]
        (small if scaled[g] < 1.0 else large).append(g)
    return keep, other


class _Records:
    """Fragments (byte strings) in one buffer; draws are fragment ids, and a
    run of ids becomes bytes by one ragged gather."""

    def __init__(self, spec: dict, rng: np.random.Generator):
        self.spec = spec
        self.rng = rng
        self.parts: list[bytes] = []
        self.lens: list[np.ndarray] = []
        self.n = 0
        self.vocabs: dict[str, list[bytes]] = {}
        self.pools: dict[str, dict] = {}
        self.empty = self._register([b""])[0]
        for name in spec.get("pools", {}):
            self._pool(name)
        self.templates = [(float(t["weight"]), self._parse(t["template"])) for t in spec["templates"]]

    # -- fragments

    def _register(self, items: list[bytes]) -> np.ndarray:
        ids = np.arange(self.n, self.n + len(items), dtype=np.int64)
        lens = np.fromiter((len(b) for b in items), np.int64, len(items))
        self.parts.append(b"".join(items))
        self.lens.append(lens)
        self.n += len(items)
        self._flat = None
        return ids

    def _register_buffer(self, buf: bytes, lens: np.ndarray) -> np.ndarray:
        ids = np.arange(self.n, self.n + lens.size, dtype=np.int64)
        self.parts.append(buf)
        self.lens.append(lens.astype(np.int64))
        self.n += lens.size
        self._flat = None
        return ids

    def _table(self):
        if self._flat is None:
            buf = np.frombuffer(b"".join(self.parts), np.uint8)
            lens = np.concatenate(self.lens)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            self._flat = (buf, starts, lens)
        return self._flat

    def gather(self, ids: np.ndarray) -> tuple[bytes, np.ndarray]:
        """The bytes of the fragment ids, end to end, and each id's length."""
        buf, starts, lens = self._table()
        ln = lens[ids]
        total = int(ln.sum())
        if total == 0:
            return b"", ln
        it = np.int32 if max(total, buf.size) < (1 << 31) else np.int64
        ln_i = ln.astype(it)
        idx = np.repeat(starts[ids].astype(it) - (np.cumsum(ln_i, dtype=it) - ln_i), ln_i)
        idx += np.arange(total, dtype=it)
        return buf[idx].tobytes(), ln

    # -- pools

    def _probs(self, n: int, spec: dict) -> np.ndarray | None:
        if "p" in spec:
            p = np.asarray(spec["p"], np.float64)
            return p / p.sum()
        if "zipf" in spec:
            p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(spec["zipf"])
            return p / p.sum()
        return None

    def _vocab(self, name: str, spec: dict) -> list[bytes]:
        if name not in self.vocabs:
            letters = np.frombuffer(spec["letters"].encode("utf-8"), np.uint8)
            n = int(spec["size"])
            lo, hi = spec["len"]
            mean = float(spec.get("len_mean", (lo + hi) / 2))
            lens = np.clip(self.rng.poisson(mean - lo, n) + lo, lo, hi)
            lens.sort()  # frequent words are the short ones
            lens = np.clip(lens + self.rng.integers(-1, 2, n), lo, hi)
            if spec.get("multibyte"):
                # letters is a list of UTF-8 letters split by "|"
                alphabet = [s.encode("utf-8") for s in spec["letters"].split("|")]
                picks = self.rng.choice(len(alphabet), int(lens.sum()))
                flat = [alphabet[i] for i in picks.tolist()]
                words, pos = [], 0
                for ln in lens.tolist():
                    words.append(b"".join(flat[pos : pos + ln]))
                    pos += ln
            else:
                picks = letters[self.rng.integers(0, letters.size, int(lens.sum()))].tobytes()
                ends = np.cumsum(lens)
                words = [picks[e - ln : e] for e, ln in zip(ends.tolist(), lens.tolist())]
            self.vocabs[name] = words
        return self.vocabs[name]

    def _pool(self, name: str) -> dict:
        if name in self.pools:
            return self.pools[name]
        spec = self.spec["pools"][name]
        kind = spec["type"]
        pool = {"kind": kind, "spec": spec, "sep": spec.get("sep", "").encode("utf-8")}
        self.pools[name] = pool  # registered first: a template may draw from itself
        if kind == "words":
            vname = spec.get("vocab", name)
            vspec = self.spec.get("vocabs", {}).get(vname, spec)
            words = self._vocab(vname, vspec)
            case = spec.get("case", "lower")
            if case == "title":
                words = [w[:1].upper() + w[1:] for w in words]
            elif case == "upper":
                words = [w.upper() for w in words]
            self._finite(pool, words, spec)
        elif kind == "ints":
            lo, hi = int(spec["lo"]), int(spec["hi"])
            fmt = spec.get("fmt", "%d")
            if hi - lo + 1 <= 200_000:
                values = np.arange(lo, hi + 1)
            else:
                values = np.sort(self.rng.integers(lo, hi + 1, 200_000))
            self._finite(pool, [(fmt % v).encode() for v in values.tolist()], spec)
        elif kind == "floats":
            vals = self.rng.uniform(float(spec["lo"]), float(spec["hi"]), int(spec["distinct"]))
            fmt = spec.get("fmt", "%.4f")
            self._finite(pool, [(fmt % v).encode() for v in vals.tolist()], spec)
        elif kind == "choice":
            items = [bytes.fromhex(s[4:]) if s.startswith("hex:") else s.encode("utf-8") for s in spec["items"]]
            self._finite(pool, items, spec)
        elif kind == "le":
            lo, hi, nb = int(spec["lo"]), int(spec["hi"]), int(spec["bytes"])
            n = min(hi - lo + 1, int(spec.get("distinct", 65536)))
            vals = np.arange(lo, lo + n) if n == hi - lo + 1 else self.rng.integers(lo, hi + 1, n)
            items = [int(v).to_bytes(nb, "little", signed=lo < 0) for v in vals.tolist()]
            self._finite(pool, items, spec)
        elif kind == "random":
            pool["bytes"] = int(spec["bytes"])
        elif kind == "template":
            pool["template"] = self._parse(spec["template"])
            pool["pad"] = spec.get("pad")
            if "distinct" in spec:
                # A finite set of expansions, drawn again and again.
                buf, lens = self.expand(pool["template"], int(spec["distinct"]))
                ends = np.cumsum(lens).tolist()
                self._finite(pool, [buf[e - n : e] for e, n in zip(ends, lens.tolist())], spec)
        elif kind == "mix":
            pool["of"] = [(self._pool(k), float(w)) for k, w in spec["of"].items()]
            total = sum(w for _, w in pool["of"])
            pool["of"] = [(p, w / total) for p, w in pool["of"]]
        else:
            raise ValueError(f"unknown pool type {kind!r}")
        return pool

    def _finite(self, pool: dict, items: list[bytes], spec: dict) -> None:
        pool["ids"] = self._register(items)
        pool["sep_ids"] = self._register([pool["sep"] + b for b in items])
        p = self._probs(len(items), spec)
        pool["alias"] = None if p is None else _alias(p)

    def draw(self, pool: dict, n: int, with_sep: bool = False) -> np.ndarray:
        kind = pool["kind"]
        if n == 0:
            return np.zeros(0, np.int64)
        if "ids" in pool:
            pick = self.rng.integers(0, pool["ids"].size, n)
            if pool["alias"] is not None:
                keep, other = pool["alias"]
                pick = np.where(self.rng.random(n) < keep[pick], pick, other[pick])
            return (pool["sep_ids"] if with_sep else pool["ids"])[pick]
        if kind == "random":
            nb = pool["bytes"]
            raw = self.rng.integers(0, 256, n * nb, dtype=np.uint8).reshape(n, nb)
            if with_sep and pool["sep"]:
                raw = np.concatenate([np.tile(np.frombuffer(pool["sep"], np.uint8), (n, 1)), raw], 1)
            return self._register_buffer(raw.tobytes(), np.full(n, raw.shape[1]))
        if kind == "template":
            buf, lens = self.expand(pool["template"], n)
            if pool["pad"]:
                width = int(pool["pad"])
                cut = np.minimum(lens, width)
                padded = np.zeros((n, width), np.uint8)
                src = np.frombuffer(buf, np.uint8)
                offs = np.cumsum(lens) - lens
                row = np.repeat(np.arange(n), cut)
                col = np.arange(int(cut.sum())) - np.repeat(np.cumsum(cut) - cut, cut)
                padded[row, col] = src[np.repeat(offs, cut) + col]
                buf, lens = padded.tobytes(), np.full(n, width)
            if with_sep and pool["sep"]:
                sep = np.frombuffer(pool["sep"], np.uint8)
                parts = np.frombuffer(buf, np.uint8)
                offs = np.cumsum(lens) - lens
                ins = np.repeat(offs, sep.size)
                buf = np.insert(parts, ins, np.tile(sep, n)).tobytes()
                lens = lens + sep.size
            return self._register_buffer(buf, lens)
        if kind == "mix":
            weights = np.array([w for _, w in pool["of"]])
            which = self.rng.choice(len(weights), n, p=weights)
            out = np.empty(n, np.int64)
            for k, (sub, _) in enumerate(pool["of"]):
                sel = np.flatnonzero(which == k)
                out[sel] = self.draw(sub, sel.size, with_sep)
            return out
        raise ValueError(kind)

    # -- templates

    def _parse(self, text: str) -> list:
        """[(literal id) | (pool, lo, hi)] of a template string."""
        out, pos = [], 0
        for m in _SLOT.finditer(text):
            if m.start() > pos:
                out.append(int(self._register([text[pos : m.start()].encode("utf-8")])[0]))
            name, lo, hi = m.group(1), m.group(2), m.group(3)
            if name not in self.spec["pools"]:
                raise ValueError(f"template names unknown pool {name!r}")
            out.append((name, None if lo is None else int(lo), None if hi is None else int(hi)))
            pos = m.end()
        if pos < len(text):
            out.append(int(self._register([text[pos:].encode("utf-8")])[0]))
        return out

    def expand_ids(self, template: list, n: int) -> np.ndarray:
        """The fragment ids of n expansions of a parsed template, one row
        each (rows end in empty fragments)."""
        cols = []
        for slot in template:
            if isinstance(slot, int):
                cols.append(np.full((n, 1), slot, np.int64))
                continue
            name, lo, hi = slot
            pool = self._pool(name)
            if lo is None:
                cols.append(self.draw(pool, n)[:, None])
                continue
            count = self.rng.integers(lo, hi + 1, n)
            mat = np.full((n, hi), self.empty, np.int64)
            live = np.arange(hi)[None, :] < count[:, None]
            mat[live] = self.draw(pool, int(count.sum()), with_sep=True)
            cols.append(mat)
        return np.concatenate(cols, 1)

    def expand(self, template: list, n: int) -> tuple[bytes, np.ndarray]:
        """n expansions of a parsed template: their bytes end to end, and
        each one's length."""
        ids = self.expand_ids(template, n)
        buf, ln = self.gather(ids.reshape(-1))
        return buf, ln.reshape(n, -1).sum(1)

    def piece(self, nbytes: int, rng: np.random.Generator) -> bytes:
        """At least ``nbytes`` of records drawn with ``rng``, on a copy of
        this generator's pools (so that pieces of one object share its
        vocabularies, and may be made on several threads at once)."""
        self._table()
        gen = copy.copy(self)
        gen.rng = rng
        gen.parts, gen.lens = list(self.parts), list(self.lens)
        weights = np.array([w for w, _ in self.templates])
        weights /= weights.sum()
        # The average record's length, from a small first draw, sizes the
        # second.
        pieces, have, n_rec = [], 0, 64
        while have < nbytes:
            which = rng.choice(len(weights), n_rec, p=weights)
            mats = {}
            for k, (_, tpl) in enumerate(gen.templates):
                sel = np.flatnonzero(which == k)
                if sel.size:
                    mats[k] = (sel, gen.expand_ids(tpl, sel.size))
            width = max(m.shape[1] for _, m in mats.values())
            ids = np.full((n_rec, width), gen.empty, np.int64)
            for sel, m in mats.values():
                ids[sel, : m.shape[1]] = m
            chunk, _ = gen.gather(ids.reshape(-1))
            if "tar" in self.spec:
                chunk = gen._tar(chunk, int(self.spec["tar"]))
            pieces.append(chunk)
            have += len(chunk)
            n_rec = max(16, int((nbytes - have) / max(1.0, len(chunk) / n_rec) * 1.02) + 1)
        return b"".join(pieces)

    def _tar(self, data: bytes, file_bytes: int) -> bytes:
        """``data`` cut into files of about ``file_bytes`` (exponential
        sizes), each behind a 512-byte ustar-like header and NUL-padded to
        a multiple of 512."""
        src = np.frombuffer(data, np.uint8)
        sizes = np.maximum(1, self.rng.exponential(file_bytes, len(data) // max(1, file_bytes) * 3 + 8)).astype(np.int64)
        ends = np.cumsum(sizes)
        sizes = sizes[: int(np.searchsorted(ends, len(data))) + 1]
        sizes[-1] -= int(sizes.sum()) - len(data)
        sizes = sizes[sizes > 0]
        names = self.draw(self._pool(self.spec["tar_names"]), sizes.size) if "tar_names" in self.spec else None
        name_bytes, name_lens = self.gather(names) if names is not None else (b"", np.zeros(sizes.size, np.int64))
        padded = (sizes + 511) // 512 * 512
        out = np.zeros(int((padded + 512).sum()), np.uint8)
        head = np.concatenate([[0], np.cumsum(padded + 512)[:-1]])
        nb = np.frombuffer(name_bytes, np.uint8)
        noff = np.cumsum(name_lens) - name_lens
        nlen = np.minimum(name_lens, 99)
        j = np.arange(int(nlen.sum())) - np.repeat(np.cumsum(nlen) - nlen, nlen)
        out[np.repeat(head, nlen) + j] = nb[np.repeat(noff, nlen) + j]
        fields = b"0000644\x000001750\x000001750\x00"
        fb = np.frombuffer(fields, np.uint8)
        out[(head[:, None] + 100 + np.arange(fb.size)[None, :]).reshape(-1)] = np.tile(fb, sizes.size)
        size_txt = np.frombuffer(b"".join(b"%011o\x00" % s for s in sizes.tolist()), np.uint8)
        out[(head[:, None] + 124 + np.arange(12)[None, :]).reshape(-1)] = size_txt
        magic = np.frombuffer(b"ustar\x0000", np.uint8)
        out[(head[:, None] + 257 + np.arange(magic.size)[None, :]).reshape(-1)] = np.tile(magic, sizes.size)
        body = head + 512
        soff = np.cumsum(sizes) - sizes
        idx = np.repeat(body - soff, sizes) + np.arange(len(data))
        out[idx] = src
        return out.tobytes()
