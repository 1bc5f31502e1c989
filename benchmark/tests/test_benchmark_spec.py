"""BENCHMARK.json's names and units, finding a cell, a configuration, a
traffic mix and a metric by name, the seeded stream order, the pool and
the yardstick's byte count."""
import itertools
import json
import os

import pytest

from conftest import ROOT
from harness import pool as pool_mod
from harness import spec, yardstick


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_keep_the_rules():
    assert spec.check_names(bench()) == []


@pytest.mark.parametrize("bad", ["has space", "a,b", "x/y", "", "-x" * 40,
                                 "µs"])
def test_bad_names_are_found(bad):
    b = bench()
    b["per_layer"] = b["per_layer"] + [dict(b["per_layer"][0], name=bad)]
    assert bad in spec.check_names(b)


@pytest.mark.parametrize("unit,ok", [("frames/s", True), ("%", True),
                                     ("ms/frame", True),
                                     ("stage_s/wall_s", True),
                                     ("frames per s", False),
                                     ("µs", False), ("x" * 17, False)])
def test_units(unit, ok):
    b = bench()
    b["end_to_end"] = [dict(b["end_to_end"][0], unit=unit)] + \
        b["end_to_end"][1:]
    assert (unit not in spec.check_names(b)) == ok


def test_duplicate_names_are_found():
    b = bench()
    b["workloads"] = b["workloads"] + b["workloads"][:1]
    assert b["workloads"][0]["name"] in spec.check_names(b)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = spec.load_cell(ROOT, cell)
    assert c.chips == 1
    assert set(c.end_to_end) == {"fps", "setup_s"}
    assert c.per_layer, cell
    for name in list(c.end_to_end) + list(c.per_layer):
        assert callable(spec.load_reader(ROOT, name))
    assert "settings" in c.traffic and "control" in c.config
    streams = pool_mod.load_pool(ROOT, c.config)
    assert len(streams) == len(c.config["pool"]["seeds"]) >= 6
    assert all(len(s.units) == c.config["frames_per_stream"] and
               len(s.planes_md5["grain"]) == len(s.units) and
               len(s.planes_md5["nograin"]) == len(s.units)
               for s in streams)


def test_only_listed_cells_report_a_limited_metric():
    b = bench()
    for m in b["per_layer"]:
        for cell in b["workloads"]:
            reports = m["name"] in spec.load_cell(ROOT,
                                                  cell["name"]).per_layer
            assert reports == (cell["name"] in m.get(
                "workloads", [cell["name"]]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "no_such.cell")


def test_every_file_is_used():
    """Each configuration, traffic and metric file belongs to an entry."""
    b = bench()
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    on_disk = {f[:-3] for f in os.listdir(os.path.join(
        ROOT, "benchmark", "metrics")) if f.endswith(".py")}
    assert on_disk == metrics
    traffic = {f[:-5] for f in os.listdir(os.path.join(
        ROOT, "benchmark", "traffic"))}
    assert traffic == {w["traffic"] for w in b["workloads"]}
    assert {c["file"] for c in b["configs"]} == {
        f"benchmark/configs/{f}" for f in os.listdir(
            os.path.join(ROOT, "benchmark", "configs"))}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 33 - 1])
def test_stream_order_is_seeded_and_covers_the_pool(seed):
    a = list(itertools.islice(pool_mod.stream_order(12, seed), 36))
    b = list(itertools.islice(pool_mod.stream_order(12, seed), 36))
    assert a == b
    for k in range(3):
        assert sorted(a[12 * k:12 * k + 12]) == list(range(12))


def test_stream_order_differs_between_seeds():
    orders = {tuple(itertools.islice(pool_mod.stream_order(12, s), 12))
              for s in range(20)}
    assert len(orders) == 20


def test_ivf_units():
    data = b"DKIF" + bytes([0, 0, 32, 0]) + b"AV01" + bytes(20)
    for payload in (b"abc", b"", b"defgh"):
        data += len(payload).to_bytes(4, "little") + bytes(8) + payload
    assert pool_mod.ivf_units(data) == [b"abc", b"", b"defgh"]
    with pytest.raises(ValueError):
        pool_mod.ivf_units(data[:-1])


@pytest.mark.parametrize("shapes,bd,want", [
    ([(1080, 1920), (540, 960), (540, 960)], 8, 1920 * 1080 + 2 * 960 * 540),
    ([(1080, 1920), (540, 960), (540, 960)], 10,
     2 * (1920 * 1080 + 2 * 960 * 540)),
    ([(1080, 1920), (1080, 960), (1080, 960)], 12,
     2 * (1920 * 1080 + 2 * 960 * 1080)),
    ([(1080, 1920)] * 3, 10, 2 * 3 * 1920 * 1080),
    ([(1081, 1707), (541, 854), (541, 854)], 8, 1707 * 1081 + 2 * 854 * 541),
    ([(64, 64)], 8, 64 * 64),
])
def test_frame_bytes(shapes, bd, want):
    assert yardstick.frame_bytes(shapes, bd) == want


def test_filters_least_time():
    shapes = [(1080, 1920), (540, 960), (540, 960)]
    least = yardstick.filters_least_s(shapes, 8, "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(2 * 3110400 / 3.35e12)
    # an unknown card has no peak: no share is reported, never 0
    assert yardstick.filters_least_s(shapes, 8, "cpu") is None
