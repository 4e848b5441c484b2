"""Tiny cells for the CPU tests: the cells' modes and generators at
sizes the plain versions run in seconds."""

import torch

from portbench import run

HH_CELL = {"mode": "heavy_hitters", "generator": "planted",
           "params": {"reports": 64, "planted": 3, "share_heavy": 0.6,
                      "threshold_share": 0.1, "shard_chunk": 40}}
HH_CONFIG = {"instantiation": {"class": "MasticCount", "args": [8]},
             "value_len": 2, "field": "Field64"}
ATTR_CELL = {"mode": "attribute_metrics", "generator": "attributes",
             "params": {"reports": 48, "pool": 2, "asked": 4,
                        "share_asked": 0.8, "max_weight": 255,
                        "tamper_cw_share": 0.05, "tamper_proof_share": 0.05,
                        "shard_chunk": 48}}
ATTR_CONFIG = {"instantiation": {"class": "MasticSum", "args": [12, 255]},
               "value_len": 17, "field": "Field64"}
# The chunked round over the upload store, on a histogram's buckets.
HIST_CELL = {"mode": "attribute_metrics", "generator": "attributes",
             "params": {"reports": 48, "pool": 2, "asked": 4,
                        "share_asked": 0.8, "max_weight": 3,
                        "tamper_cw_share": 0.05, "tamper_proof_share": 0.05,
                        "shard_chunk": 48, "chunk_size": 20}}
HIST_CONFIG = {"instantiation": {"class": "MasticHistogram",
                                 "args": [10, 4, 2]},
               "value_len": 5, "field": "Field128", "buckets": 4}
CELLS = {"hh": (HH_CELL, HH_CONFIG), "attr": (ATTR_CELL, ATTR_CONFIG),
         "hist": (HIST_CELL, HIST_CONFIG)}


def run_tiny(which: str, seed: int = 2 ** 31 + 5, seconds: float = 0.2,
             trace: bool = False) -> dict:
    (cell, config) = CELLS[which]
    return run.run_cell(which, cell, config, seed, seconds, trace,
                        torch.device("cpu"))
