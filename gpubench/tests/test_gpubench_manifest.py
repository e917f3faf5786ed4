"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from gpubench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

MANIFEST = core.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["gpubench"]
    assert MANIFEST["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for x in MANIFEST["configs"] + MANIFEST["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16


def test_entry_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = core.find_cell(MANIFEST, cell)
    assert c.config["name"] == c.entry["config"]
    entry = core.entry_module(c)
    assert hasattr(entry.Entry, "request") and hasattr(entry.Entry, "judge")
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
    assert set(c.traffic["check"]["limits"]) <= {"worse_share", "chi2_mismatch_share",
                                                  "texels_unmatched", "image_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(core.metric_module(metric).read)


def test_config_files_under_paths_and_boxes():
    from brdf_tpu_torch.models.brdf import MODELS
    from brdf_tpu_torch.models.normalmap import joint_spec

    for c in MANIFEST["configs"]:
        assert c["file"].startswith("gpubench/configs/")
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        if cfg.get("joint_normalmap"):
            spec = joint_spec(cfg["model"], cfg["max_tilt"])
            assert cfg["box"] == {"lower": list(spec.lower), "upper": list(spec.upper)}
        else:
            spec = MODELS[cfg["model"]]
            assert cfg["box"] == {"lower": list(spec.lower), "upper": list(spec.upper)}


def test_every_config_used_and_one_chip_cells():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
