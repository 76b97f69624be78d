"""BENCHMARK.json against the files it names: every cell has its workload
and configuration file, every configuration its reference file, every
per-layer metric its reader, and every metric's cells report what it
moves."""

import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in MANIFEST[k]}) == len(MANIFEST[k])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_cells_find_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (BENCH / "traffic" / f"{w['traffic']}.py").exists()
        cfg = json.loads((BENCH.parent / configs[w["config"]]["file"]).read_text())
        assert cfg["source"] == configs[w["config"]]["source"]
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
        # the optional `reference` key: a file of reference/, generator.py by default
        assert (BENCH / "reference" / cfg.get("reference", "generator.py")).is_file()


def test_metrics_have_readers_and_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in MANIFEST["per_layer"])
        assert sum(cell in m.get("workloads", cells) for m in e2e.values()) >= 2


def test_vocoder_reader_in_the_offline_cells():
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == "vocoder.device_ms")
    assert entry == {"name": "vocoder.device_ms", "unit": "ms", "better": "lower",
                     "source": "device_trace", "layer": "L2 modules", "moves": "audio_s_per_s",
                     "workloads": ["convnext.offline", "conformer.offline"]}
    layers = {m["name"]: m["layer"] for m in MANIFEST["per_layer"]}
    assert layers["decoder.device_ms"] == entry["layer"]
