"""A cell cut to a tiny size for the CPU: the same files, the model's
widths and the load shrunk, fp32 compute."""

import copy
import time

import torch

from perfbench import runtime, spec

#: tiny widths; weights wider than the published init, so that attention
#: moves the logits enough for a wrong cache to show in a few tokens
TINY = dict(d_model=64, n_layers=2, n_heads=4, max_seq_len=64, vocab_size=128,
            emb_init_std=0.5)
SEED = 2**31 + 12345


#: the cells' files, listed in BENCHMARK.json or not
FILES = {"train.mpt-125m": ("perfbench/configs/mpt-125m.json", "train"),
         "serve.mpt-1b.chat": ("perfbench/configs/mpt-1b.json", "chat")}


def cell(name: str) -> spec.Cell:
    c = copy.deepcopy(spec.cell_from_files(name, *FILES[name]))
    port = c.config["port"]
    port["model"].update(TINY, compute_dtype="float32")
    if "train" in port:
        port["train"].update(global_batch_size=4, device_microbatch_size=2)
        c.traffic["ref_rows_per_pass"] = 2
    if "photon" in port:
        port["photon"]["serve"].update(n_slots=4, prefill_token_budget=64, max_new_tokens=16)
        c.traffic.update(rate_per_s=4.0, warm_s=1.0, tail_s=5, drain_s=30, check_tokens=20,
                         prompt_len={"dist": "lognormal", "median": 16, "sigma": 0.8,
                                     "min": 4, "max": 40},
                         output_len={"dist": "lognormal", "median": 6, "sigma": 0.7,
                                     "min": 2, "max": 16})
    return c


def run(c: spec.Cell, seconds: float = 1.5, **kw) -> runtime.Result:
    torch.manual_seed(0)
    ctx = runtime.Context(c, SEED, seconds, False, torch.device("cpu"), time.perf_counter(), **kw)
    return spec.runner(c).run(ctx)
