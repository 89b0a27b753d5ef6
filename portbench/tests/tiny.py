"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
harness's tests: a configuration's and a mix's files as they are, the
clip, keypoints and mesh made small."""

import copy

from portbench import harness as H

# cell → (configuration, traffic mix, frames); 128 keypoints a frame and a
# 24 × 32 sphere in each.
CELLS = {"track.buddha1m": ("hd1080-buddha1m", "track_pass", 24),
         "refine.buddha1m": ("hd1080-buddha1m", "refine_call", 30)}


def tiny_cell(name):
    config, traffic, frames = CELLS[name]
    bench = dict(H.read_json(H.ROOT / "BENCHMARK.json"),
                 configs=[{"name": config,
                           "file": f"portbench/configs/{config}.json"}],
                 workloads=[{"name": name, "config": config,
                             "traffic": traffic, "chips": 1}])
    cell = H.resolve(bench, name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["clip"]["frames"] = frames
    cell.config["keypoints_per_frame"] = 128
    cell.config["mesh"]["uv_sphere"] = [24, 32]
    return cell
