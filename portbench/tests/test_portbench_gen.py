"""The traffic generator: exact sizes, one result a seed."""

import hashlib
import json

import numpy as np
import pytest

from portbench import gen

SILESIA = {"dickens": 10192446, "mozilla": 51220480, "mr": 9970564, "nci": 33553445, "ooffice": 6152192,
           "osdb": 10085684, "reymont": 6627202, "samba": 21606400, "sao": 7251944, "webster": 41458703,
           "xml": 5345280, "x-ray": 8474240}


def test_silesia_has_the_corpus_sizes():
    mix = gen.load_mix("silesia")
    assert mix["op"] == "compress"
    assert {o["name"]: o["bytes"] for o in mix["objects"]} == SILESIA
    assert sum(SILESIA.values()) == 211_938_580


def test_enwik_and_packed_sizes():
    enwik, packed = gen.load_mix("enwik"), gen.load_mix("packed")
    assert enwik["op"] == "decompress" and [o["bytes"] for o in enwik["objects"]] == [12_500_000] * 8
    assert packed["op"] == "compress" and [o["bytes"] for o in packed["objects"]] == [16_000_000] * 8


def _small(name: str, size: int) -> dict:
    mix = gen.load_mix(name)
    mix = json.loads(json.dumps(mix))
    for o in mix["objects"]:
        o["bytes"] = size
    return mix


@pytest.mark.parametrize("name", ["silesia", "enwik", "packed"])
def test_one_result_a_seed(name):
    mix = _small(name, 70_001)
    a = gen.make_objects(mix, 2**31 + 11, threads=2)
    b = gen.make_objects(mix, 2**31 + 11, threads=3)
    c = gen.make_objects(mix, 2**31 + 12, threads=2)
    assert [len(d) for _, d in a] == [70_001] * len(mix["objects"])
    assert [d for _, d in a] == [d for _, d in b]
    assert all(x != y for (_, x), (_, y) in zip(a, c))


def test_pieces_join_without_seams():
    """An object longer than a piece is made of several, each exact."""
    mix = _small("silesia", gen.PIECE + 12_345)
    mix["objects"] = mix["objects"][:1]
    (_, data), = gen.make_objects(mix, 5, threads=2)
    assert len(data) == gen.PIECE + 12_345
    digest = hashlib.sha1(data).hexdigest()
    (_, again), = gen.make_objects(mix, 5, threads=1)
    assert hashlib.sha1(again).hexdigest() == digest


def test_classes_differ_in_shape():
    """Text is text and the packed class is incompressible."""
    mix = _small("silesia", 50_000)
    objs = dict(gen.make_objects(mix, 3, threads=2))
    assert objs["dickens"].decode("utf-8", "replace").count(" ") > 5_000
    assert b"$$$$" in objs["nci"]
    import bz2

    packed = dict(gen.make_objects(_small("packed", 50_000), 3, threads=2))
    assert len(bz2.compress(packed["member1"], 9)) > 50_000
    assert np.frombuffer(objs["mr"], "<u2").max() > 0
