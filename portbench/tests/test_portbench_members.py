"""How the harness writes a decode cell's input: one stdlib stream an
object, or the members its configuration states (``members``), and the
configurations it refuses."""

import bz2
import json
import shutil

import pytest

from portbench import gen, run

SEED = 2**31 + 31
PAGE = b"</page>\n"
CELLS = [w["name"] for w in run.load_bench()["workloads"]]


def _streams(data: bytes) -> list[tuple[bytes, bytes]]:
    """(stream, what it decodes to) of each bzip2 stream of ``data``, read
    by the standard library one stream at a time."""
    out = []
    while data:
        d = bz2.BZ2Decompressor()
        raw = d.decompress(data)
        assert d.eof, "a cut stream"
        used = len(data) - len(d.unused_data)
        out.append((data[:used], raw))
        data = d.unused_data
    return out


def _root_with(small_root, tmp_path, members):
    root = tmp_path / "root"
    shutil.copytree(small_root, root)
    path = root / "portbench" / "configs" / "bzip2-l9.json"
    conf = json.loads(path.read_text())
    conf["members"] = members
    path.write_text(json.dumps(conf))
    return root


def _cell(root, workload):
    _, config, mix = run.cell_spec(run.load_bench(root), workload, root)
    return run.Cell(config, mix, SEED, port=None, threads=2), config, mix


@pytest.mark.parametrize("workload", CELLS)
def test_without_members_the_inputs_are_the_parents(small_root, workload):
    """One stdlib stream an object (decode), the object itself (compress)."""
    cell, config, mix = _cell(small_root, workload)
    raw = [d for _, d in gen.make_objects(mix, SEED, threads=3)]
    assert cell.raw == raw
    if cell.op == "decompress":
        assert cell.inputs == [bz2.compress(d, int(config["level"])) for d in raw]
        assert cell.members == [1] * len(raw)
    else:
        assert cell.inputs == raw and cell.members == []


@pytest.mark.parametrize("k", [1, 10, 1000])
def test_members_of_k_pages(small_root, tmp_path, k):
    root = _root_with(small_root, tmp_path, {"records": k, "after": PAGE.decode()})
    cell, _, _ = _cell(root, "l9-enwik-decompress")
    for obj, data, n in zip(cell.raw, cell.inputs, cell.members):
        pages = obj.count(PAGE) + (not obj.endswith(PAGE))
        got = _streams(data)
        assert len(got) == n == -(-pages // k) and n >= 1
        assert b"".join(raw for _, raw in got) == obj == bz2.decompress(data)
        for j, (stream, raw) in enumerate(got):
            assert stream[:4] == b"BZh9" and stream == bz2.compress(raw, 9)
            if j < n - 1:
                assert raw.endswith(PAGE) and raw.count(PAGE) == k
            else:
                assert 1 <= raw.count(PAGE) + (not raw.endswith(PAGE)) <= k


@pytest.mark.parametrize("n", [35_000, 40_000, 1_000_000])
def test_members_of_n_bytes(small_root, tmp_path, n):
    root = _root_with(small_root, tmp_path, {"bytes": n})
    cell, _, _ = _cell(root, "l9-enwik-decompress")
    for obj, data, count in zip(cell.raw, cell.inputs, cell.members):
        got = _streams(data)
        assert len(got) == count == -(-len(obj) // n)
        assert b"".join(raw for _, raw in got) == obj == bz2.decompress(data)
        at = 0
        for stream, raw in got:
            assert stream[:4] == b"BZh9" and stream == bz2.compress(raw, 9)
            assert at % n == 0 and len(raw) == min(n, len(obj) - at)
            at += len(raw)


@pytest.mark.parametrize("data,members,want", [
    (b"a;b;c;d;", {"records": 2, "after": ";"}, [b"a;b;", b"c;d;"]),
    (b"a;b;c;d;e", {"records": 2, "after": ";"}, [b"a;b;", b"c;d;", b"e"]),
    (b"a;b;c", {"records": 5, "after": ";"}, [b"a;b;c"]),
    (b";;;", {"records": 1, "after": ";;"}, [b";;", b";"]),
    (b"", {"records": 1, "after": ";"}, [b""]),
    (b"abcdefg", {"bytes": 3}, [b"abc", b"def", b"g"]),
    (b"abcdef", {"bytes": 3}, [b"abc", b"def"]),
    (b"abc", None, [b"abc"]),
])
def test_split_members(data, members, want):
    assert [bytes(p) for p in run.split_members(data, members)] == want


@pytest.mark.parametrize("workload,members", [
    ("l9-silesia-compress", {"bytes": 900_000}),
    ("l9-enwik-decompress", {"records": 100}),
    ("l9-enwik-decompress", {"after": "</page>\n"}),
    ("l9-enwik-decompress", {"pages": 100, "after": "</page>\n"}),
    ("l9-enwik-decompress", {"records": 100, "after": "</page>\n", "bytes": 900_000}),
    ("l9-enwik-decompress", {"records": 0, "after": "</page>\n"}),
    ("l9-enwik-decompress", {"records": -1, "after": "</page>\n"}),
    ("l9-enwik-decompress", {"records": 100, "after": ""}),
    ("l9-enwik-decompress", {"records": 100, "after": 7}),
    ("l9-enwik-decompress", {"records": 2.5, "after": "</page>\n"}),
    ("l9-enwik-decompress", {"bytes": 0}),
    ("l9-enwik-decompress", {"bytes": "900000"}),
    ("l9-enwik-decompress", {"bytes": True}),
    ("l9-enwik-decompress", [100, "</page>\n"]),
    ("l9-enwik-decompress", None),
])
def test_a_malformed_members_is_refused(small_root, tmp_path, workload, members):
    root = _root_with(small_root, tmp_path, members)
    with pytest.raises(SystemExit, match="members"):
        run.cell_spec(run.load_bench(root), workload, root)


def test_a_members_cell_runs_and_its_host_decode_is_judged(small_root, tmp_path, counted_launches, capsys):
    """A multistream input is written, set-up says so, every output is
    judged against its object; the port hands such a stream to its host
    decoder, which the judge counts as off the card."""
    root = _root_with(small_root, tmp_path, {"records": 10, "after": PAGE.decode()})
    r = run.run_cell(run.load_bench(root), "l9-enwik-decompress", SEED, 0.3, False, device="cpu", threads=2,
                     root=root)
    cell, _, _ = _cell(root, "l9-enwik-decompress")
    n = cell.members
    assert (f"portbench: set-up input {sum(n)} members ({min(n)}-{max(n)} an object of 3), "
            f"{sum(map(len, cell.inputs))} bytes") in capsys.readouterr().err
    assert sum(n) > 3
    assert r["checks"]["bad_outputs"]["value"] == 0 and r["checks"]["errors"]["value"] == 0
    assert r["checks"]["off_card_calls"]["value"] == r["attempted"] >= 1
    assert r["correct"] is False and r["failed"] == r["attempted"]
