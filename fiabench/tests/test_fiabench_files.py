"""Every file the harness finds by name parses, and BENCHMARK.json keeps
to the shape its schema gives it: keys, names, units, bounds and limits."""

import json
import os
import re

import pytest

from fiabench import check, data
from fiabench.spec import HERE, ROOT, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_shape():
    doc = _doc()
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["fiabench"]
    assert doc["command"] == ["python3", "fiabench/run.py"]
    assert 1 <= doc["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_texts():
    doc = _doc()
    names = [e["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in doc[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in doc["configs"] + doc["workloads"]:
        assert TEXT.match(e["why"])
    for m in doc["per_layer"]:
        assert TEXT.match(m["layer"])


def test_end_to_end_bounds():
    doc = _doc()
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert set(e2e) == {"scores_per_s", "job_p95_ms", "setup_s"}
    for m in e2e.values():
        assert m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25


def test_cells_and_their_files(spec):
    doc = _doc()
    configs = {c["name"] for c in doc["configs"]}
    pairs = set()
    for w in doc["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        tr = spec.traffic(w["traffic"])
        assert tr["item"] in data.ITEM_DRAWS
        assert tr["job_queries"] % tr["batch_queries"] == 0
        check.load_limits(w["name"])
    assert sum(w["chips"] == 4 for w in doc["workloads"]) <= max(
        1, len(doc["workloads"]) // 4)


def test_configs_parse(spec):
    for c in _doc()["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("fiabench/")
        assert c["reduced"] == []
        for key in ("embedding_size", "weight_decay", "damping", "num_users",
                    "num_items", "num_rows", "data_seed", "family",
                    "port_model"):
            assert key in cfg


def test_every_metric_has_a_reader(spec):
    doc = _doc()
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        assert callable(metric_reader(m["name"]))
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            spec.workload(w)
    for w in doc["workloads"]:
        assert spec.metrics(w["name"], trace=True)
        assert {m["name"] for m in spec.metrics(w["name"], False)} == e2e


@pytest.mark.parametrize("sub", ["configs", "traffic", "checks"])
def test_data_files_are_json(sub):
    for name in os.listdir(os.path.join(HERE, sub)):
        with open(os.path.join(HERE, sub, name)) as f:
            json.load(f)
