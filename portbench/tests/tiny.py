"""A cell at a size a CPU test run holds: the configurations' schedule and
shapes of layers at narrow widths (SDF 4 x 64 with a skip into layer 2,
radiance 2 x 64, 16 features), 9 views at 64x48 with 32x24 depth maps,
B=2 x P=128 rays, chunks of 2 epochs of 4 steps."""
from __future__ import annotations

import copy
import json
import os
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

HOCON = """
train{
    sched_milestones = [4/6, 5/6]
    sched_factor = 0.1
    plot_freq = 1/12
}
model{
    feature_vector_size = 16
    implicit_network {
        dims = [64, 64, 64, 64]
        geometric_init = True
        bias = 0.6
        skip_in = [2]
        weight_norm = True
        multires = 6
    }
    rendering_network {
        mode = idr
        dims = [64, 64]
        weight_norm = True
        multires_view = 4
    }
}
"""


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["hocon"] = HOCON
    cfg["model"]["implicit"].update(dims=[64] * 4, skip_in=[2],
                                    feature_vector_size=16)
    cfg["model"]["render"].update(dims=[64] * 2, feature_vector_size=16)
    cfg["train"].update(batch_size=2, num_pixels=128)
    cfg["scene"].update(views=9, img_hw=[48, 64], depth_hw=[24, 32])
    return cfg


def cell(cell_name: str, config_name: str) -> types.SimpleNamespace:
    """A cell of ``BENCHMARK.json`` at the tiny size: its configuration's
    and its traffic's shapes cut down."""
    with open(os.path.join(ROOT, "portbench", "workloads",
                           cell_name + ".json")) as f:
        tr = json.load(f)
    tr["chunk_epochs"] = 2
    return types.SimpleNamespace(name=cell_name, config_name=config_name,
                                 config=config(config_name), traffic=tr,
                                 kind=tr["kind"], chips=1, end_to_end=[],
                                 per_layer=[])


def config_of(cell_name: str) -> str:
    """The configuration a cell of this folder runs: its name's first part
    (``dtu_plain.train_c`` runs ``mvsdf_dtu_plain``)."""
    return "mvsdf_" + cell_name.split(".")[0]
