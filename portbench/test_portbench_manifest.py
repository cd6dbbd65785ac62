"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell, a configuration and a metric added as new files by name."""
import json
import re
import shutil

import pytest

from portbench import harness, smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    names = [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["config"] for w in MAN["workloads"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in MAN[kind]}) == len(MAN[kind])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        e2e = [m["name"] for m in MAN["end_to_end"]
               if harness.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, w["name"]) for m in MAN["per_layer"])
    for m in MAN["per_layer"] + MAN["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_moves_are_reported():
    """Every per-layer metric's ``moves`` is an end-to-end metric that each
    of its cells reports, and one layer's metrics name it alike."""
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
        assert harness.metric_reader(m["name"])


def test_files_under_paths():
    for c in MAN["configs"]:
        assert c["file"].startswith("portbench/")
        assert (harness.ROOT / c["file"]).is_file()
    for w in MAN["workloads"]:
        cell = harness.load_json(harness.BENCH / "workloads" /
                                 f"{w['name']}.json")
        assert cell["config"] == w["config"]
        assert (harness.BENCH / "paths" / f"{cell['path']}.py").is_file()


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration of a family no cell runs yet (dense), a decode cell
    of it and a metric, added as files and entries in BENCHMARK.json, are
    found by name and run at smoke size on the CPU, with its reference
    found by the family's name, without editing a file that is there."""
    from repro_torch.serve.decode import fast_budget_pages
    from portbench import model
    from portbench.paths.decode import tiering_config
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    man = json.loads(json.dumps(MAN))
    (root / "portbench/configs/dense-smoke.json").write_text(
        json.dumps(smoke.DENSE))
    cell = json.loads((root / "portbench/workloads/zamba2-decode-tiered.json"
                       ).read_text())
    cell["config"] = "dense-smoke"
    tr = dict(cell["traffic"], **cell["smoke"]["traffic"])
    cfg = model.model_config(smoke.smoke_conf(smoke.DENSE))
    cell["smoke"]["traffic"]["fast_budget"] = fast_budget_pages(
        cfg, tiering_config(tr), tr["batch"],
        tr["prompt_tokens"] - 1 + tr["decode_tokens"])
    (root / "portbench/workloads/dense-decode.json").write_text(
        json.dumps(cell))
    (root / "portbench/metrics/steps_seen.decode.py").write_text(
        "def read(bench):\n    return len(bench.record['steps'])\n")
    man["configs"].append({"name": "dense-smoke", "source": "tests",
                           "file": "portbench/configs/dense-smoke.json",
                           "reduced": [], "why": "a dense decoder"})
    man["workloads"].append(dict(man["workloads"][0], name="dense-decode",
                                 config="dense-smoke"))
    man["per_layer"].append({"name": "steps_seen.decode", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves":
                             "decode_tokens_per_s",
                             "workloads": ["dense-decode"]})
    for m in man["end_to_end"]:
        if "workloads" in m and "zamba2-decode-tiered" in m["workloads"]:
            m["workloads"].append("dense-decode")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert p.read_bytes() == data
    monkeypatch.setattr(harness, "BENCH", root / "portbench")
    monkeypatch.setattr(harness, "ROOT", root)
    man2 = harness.manifest()
    entry, cell2, conf2 = harness.load_cell("dense-decode", man2)
    assert entry["config"] == "dense-smoke"
    assert conf2["port"]["family"] == "dense"
    assert cell2["path"] == "decode"
    run = smoke.run("dense-decode", 1, man=man2)
    assert run.correct, run.compared
    line = harness.result(run, "dense-decode", man2, trace=True)
    assert line["metrics"]["steps_seen.decode"]["value"] == len(
        run.record["steps"])


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_file_keeps_published_numbers(name):
    """The configuration's file holds its source's numbers at the top level
    (``reduced`` lists those changed), and the ``port`` table the benchmark
    runs agrees with them key by key (``port_keys``), except where the file
    names a departure of the program."""
    entry = harness.find(MAN["configs"], name, "config")
    conf = harness.load_json(harness.ROOT / entry["file"])
    assert conf["reduced"] == entry["reduced"]
    assert set(conf["reduced"]) <= set(conf)
    departures = conf.get("departures", {})
    assert set(departures) <= set(conf)
    assert conf["port_keys"]
    for port_key, published in conf["port_keys"].items():
        value = conf["port"]
        for part in port_key.split("."):
            value = value[part]
        if published not in departures:
            assert value == conf[published], (port_key, published)
