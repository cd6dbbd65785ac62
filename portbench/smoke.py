"""Small copies of the benchmark's configurations and cells, for the tests
on the CPU. Each file carries its own small copy under ``smoke``: a
configuration the sizes that replace its ``port`` table's, a cell the
traffic and the limits that replace its own (limits read at those sizes on
the CPU, with a zero-length window so that the check's sample is fixed)."""
from __future__ import annotations

import copy

from portbench import harness


def smoke_conf(conf: dict) -> dict:
    conf = copy.deepcopy(conf)
    conf["port"].update(copy.deepcopy(conf["smoke"]))
    return conf


def smoke_cell(name: str, man=None):
    """(cell file, configuration file) of cell ``name``, cut to smoke size."""
    man = man or harness.manifest()
    _, cell, conf = harness.load_cell(name, man)
    cell = copy.deepcopy(cell)
    cell["traffic"].update(cell["smoke"]["traffic"])
    cell["limits"].update(cell["smoke"]["limits"])
    return cell, smoke_conf(conf)


def run(name: str, seed: int, seconds: float = 0.0, control=False, man=None):
    """One run of cell ``name`` at smoke size on the CPU; the default
    zero-length window runs one batch, request or step, so that the run
    does not depend on the machine's speed."""
    man = man or harness.manifest()
    cell, conf = smoke_cell(name, man)
    return harness.run_cell(name, seed, seconds, False, device="cpu", man=man,
                            cell=cell, conf=conf, control=control)


# A dense decoder at smoke size, which no cell runs yet: the tests hold the
# dense reference against the program with it, and add a dense cell as
# new files.
DENSE = {
    "source": "a dense decoder at smoke size, for the tests",
    "reduced": [],
    "port": {"name": "dense-smoke", "family": "dense", "num_layers": 2,
             "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128,
             "vocab_size": 256, "head_dim": 16, "sliding_window": 32,
             "rope_theta": 10000.0, "rms_eps": 1e-05, "act": "silu",
             "dtype": "bfloat16", "param_dtype": "float32"},
    "smoke": {},
}
