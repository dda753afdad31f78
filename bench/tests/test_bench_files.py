"""``BENCHMARK.json`` and every configuration, mix, limit and metric file it
names: they parse and keep to the benchmark's format."""
import json
import re

import pytest

from bench.gen import ldbc as G
from bench.gen import traffic as TR
from bench.lib import spec as SP

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = SP.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((SP.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    assert 1200 + (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench/") and len(c["reduced"]) <= 16
        spec = json.loads((SP.ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["source"] == c["source"]
        assert set(c["reduced"]) == set(spec["reduced"])
        assert all(NAME.match(k) and k in spec for k in c["reduced"])
        p = G.params_of(spec)
        assert c["reduced"] == ["n_persons"] and p.align == 16
        # the source's per-person shape: 520 vertices a person, 23 interests
        per_person = 1 + p.posts_per_person + p.comments_per_person + p.forums_per_person
        assert abs(per_person - 520) < 1 and p.interests_per_person == 23
        srv = spec["server"]
        assert srv["impl"] == "cuda" and srv["theta"] == "DEFAULT_COEFFS"
        assert srv["mode"] == ("bucket" if p.dynamic else "static")
        # every cell's clients read totals, series and MIN/MAX
        assert srv["keep_outputs"] is True
        assert "exact" in spec["guarantee"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] == 1
    cell = SP.cell(w["name"])
    TR.check_mix(cell["mix"])
    assert set(cell["limits"]) == {"count_rel_err", "minmax_mismatches", "unanswered"}
    assert cell["limits"]["minmax_mismatches"] == 0 and cell["limits"]["unanswered"] == 0
    assert 0 < cell["limits"]["count_rel_err"] < 1e-2
    e2e = {m["name"] for m in SP.metrics_for(w["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SP.metrics_for(w["name"], "per_layer")


def test_cells_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert {m["name"] for m in e2e} >= {"query_p95_ms", "query_p50_ms", "queries_per_s",
                                        "setup_s"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in {x["name"] for x in e2e} and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (SP.BENCH / "metrics" / f"{m['name']}.py").exists()
    # one layer name a layer, letter for letter
    layers = {}
    for m in layer:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in layers.items() if k not in ("setup",))
