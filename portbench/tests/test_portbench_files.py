"""The benchmark is driven by its files: every name in BENCHMARK.json
resolves to a file of its own, a new cell, configuration, mix or metric is
new files only, and nothing a run loads is JAX or the JAX package."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness as H

BENCH = H.read_json(H.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = H.resolve(BENCH, cell)
    assert c.call.Caller and c.call.check
    assert {m["name"] for m in c.per_layer} == set(c.metric_files)
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}


def test_every_name_has_its_file():
    root = H.HERE
    for c in BENCH["configs"]:
        assert (H.ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        mix = H.read_json(root / "traffic" / f"{w['traffic']}.json")
        assert (root / "calls" / f"{mix['call']}.py").is_file()
        assert (root / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (root / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark's folder with a configuration, a mix, a
    metric and a cell added as new files resolves with no file edited."""
    root = tmp_path / "portbench"
    shutil.copytree(H.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = H.read_json(root / "configs" / "hd1080-buddha1m.json")
    cfg["name"] = "hd720-flame10k"
    cfg["clip"]["width"], cfg["clip"]["height"] = 1280, 720
    cfg["mesh"].update(source_triangles=9_976, uv_sphere=[44, 116])
    (root / "configs" / "hd720-flame10k.json").write_text(json.dumps(cfg))
    mix = H.read_json(root / "traffic" / "refine_call.json")
    mix["max_iterations"] = 10
    (root / "traffic" / "refine_short.json").write_text(json.dumps(mix))
    (root / "metrics" / "refine_cost_ms.py").write_text(
        "def read(ctx):\n    return None\n")
    (root / "limits" / "refine.hd720.json").write_text(
        json.dumps({"refine_excess_cost": 1.0}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "hd720-flame10k", "source": "x",
                             "file": "portbench/configs/hd720-flame10k.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "refine.hd720",
                               "config": "hd720-flame10k",
                               "traffic": "refine_short", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "refine_cost_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "refine stages", "moves": "refine_s",
                               "workloads": ["refine.hd720"]})
    cell = H.resolve(bench, "refine.hd720", root=root, checkout=tmp_path)
    assert cell.config["clip"]["width"] == 1280
    assert cell.traffic["max_iterations"] == 10
    # A metric that lists its cells reports only there.
    assert set(cell.metric_files) == {"refine_cost_ms"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_missing_file_refuses_the_cell():
    bench = json.loads(json.dumps(BENCH))
    cell = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "no_such_metric", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": [cell]})
    with pytest.raises(FileNotFoundError):
        H.resolve(bench, cell)


SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from portbench import harness as H
from tiny import tiny_cell
for name in ("track.buddha1m", "refine.buddha1m"):
    out = H.run_cell(tiny_cell(name), 3, 0.5, False, torch.device("cpu"),
                     time.perf_counter())
    assert out.result["correct"], out.result
for m in ("run", "calibrate", "trace", "bounds"):
    __import__("portbench." + m)
import portbench.calls  # noqa
print("FORBIDDEN", H.forbidden_modules())
"""


def test_nothing_a_run_loads_is_jax(tmp_path):
    """A whole run on the CPU at a tiny size, every metric module and the
    tools loaded, in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or polychase_tpu (compared whole: the port's name
    begins with the last)."""
    code = SCRIPT.format(root=str(H.ROOT), tests=str(H.HERE / "tests"))
    code += ("\nfor p in sorted((H.HERE / 'metrics').glob('*.py')):"
             "\n    H.load_module(p)"
             "\nprint('FORBIDDEN', H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("FORBIDDEN")]
    assert lines and all(ln == "FORBIDDEN []" for ln in lines), out.stdout


def test_the_top_level_name_is_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "polychase_tpu_torchlike", sys)
    assert "polychase_tpu" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in H.forbidden_modules()
